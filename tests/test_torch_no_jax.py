"""The PyTorch port never imports JAX, nor anything of the JAX package.

Every module of ``commu_tpu_torch`` is imported in a fresh interpreter,
which must end with no ``jax``, ``flax`` or ``commu_tpu`` module loaded: the
port keeps its own copies of the JAX-free modules it needs (config, vocab,
utils, midi, preprocess, data).  Its sources import none of the
three; ``chip_smoke.py`` neither, and without a CUDA device it exits
non-zero before printing a result.
"""
import ast
import json
import os
import pkgutil
import subprocess
import sys

from conftest import REPO_ROOT


def _port_modules():
    import commu_tpu_torch

    names = ["commu_tpu_torch"]
    for info in pkgutil.walk_packages(commu_tpu_torch.__path__,
                                      "commu_tpu_torch."):
        names.append(info.name)
    return names


def test_port_modules_import_without_jax():
    modules = _port_modules()
    assert "commu_tpu_torch.generation.device_sampler" in modules
    assert "commu_tpu_torch.ops.fused_attention" in modules
    for name in ("commu_tpu_torch.ops.fused_nll", "commu_tpu_torch.ops.layout",
                 "commu_tpu_torch.ops.embed", "commu_tpu_torch.train",
                 "commu_tpu_torch.training.step",
                 "commu_tpu_torch.training.loop",
                 "commu_tpu_torch.training.schedule",
                 "commu_tpu_torch.training.checkpoint",
                 "commu_tpu_torch.ops.prng", "commu_tpu_torch.ops.dropout",
                 "commu_tpu_torch.config", "commu_tpu_torch.vocab.meta_codec",
                 "commu_tpu_torch.utils.logging", "commu_tpu_torch.midi.smf",
                 "commu_tpu_torch.preprocess.event_codec",
                 "commu_tpu_torch.data.dataset",
                 "commu_tpu_torch.utils.chords",
                 "commu_tpu_torch.utils.midi_meta_utils",
                 "commu_tpu_torch.preprocess.meta_parser",
                 "commu_tpu_torch.preprocess.augment",
                 "commu_tpu_torch.preprocess.preprocessor",
                 "commu_tpu_torch.preprocess.pipeline",
                 "commu_tpu_torch.preprocess.__main__",
                 "commu_tpu_torch.ops.rel_attention",
                 "commu_tpu_torch.generation.host_sampler",
                 "commu_tpu_torch.parallel",
                 "commu_tpu_torch.parallel.mesh",
                 "commu_tpu_torch.parallel.multihost"):
        assert name in modules
    code = ("import importlib, json, sys\n"
            f"for name in {modules!r}:\n"
            "    importlib.import_module(name)\n"
            "print(json.dumps(sorted(m for m in sys.modules\n"
            "                        if m.split('.')[0] in\n"
            "                        ('jax', 'flax', 'commu_tpu'))))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO_ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.splitlines()[-1]) == []


def test_port_sources_name_no_jax():
    for root, _, files in os.walk(os.path.join(REPO_ROOT, "commu_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as fh:
                    tree = ast.parse(fh.read())
                for node in ast.walk(tree):
                    if isinstance(node, ast.Import):
                        mods = [a.name for a in node.names]
                    elif isinstance(node, ast.ImportFrom) and node.level == 0:
                        mods = [node.module]
                    else:
                        continue
                    for mod in mods:
                        top = mod.split(".")[0]
                        assert top not in ("jax", "flax", "commu_tpu"), \
                            (name, mod)


def test_chip_smoke_imports_and_cpu_refusal():
    path = os.path.join(REPO_ROOT, "chip_smoke.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] not in ("jax", "flax", "commu_tpu"), mod
    proc = subprocess.run([sys.executable, path], capture_output=True,
                          text=True, cwd=REPO_ROOT, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_preprocess_sources_name_no_torch_or_pandas():
    """The preprocess pipeline and its helpers are pure Python over numpy:
    the CLI runs where neither torch nor pandas is installed."""
    names = [os.path.join("utils", "chords.py"),
             os.path.join("utils", "midi_meta_utils.py")] + [
        os.path.join("preprocess", f) for f in os.listdir(
            os.path.join(REPO_ROOT, "commu_tpu_torch", "preprocess"))
        if f.endswith(".py")]
    assert len(names) == 9
    for name in names:
        with open(os.path.join(REPO_ROOT, "commu_tpu_torch", name)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in ("torch", "pandas"), (name, mod)
