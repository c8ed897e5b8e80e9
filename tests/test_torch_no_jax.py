"""The PyTorch port never imports JAX: the machine with the card has no JAX.

Every module of ``commu_tpu_torch`` is imported in a fresh interpreter,
which must end with neither ``jax`` nor ``flax`` loaded; ``chip_smoke.py``
imports nothing of JAX or of the JAX package directly, and without a CUDA
device it exits non-zero before printing a result.
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
                 "commu_tpu_torch.training.checkpoint"):
        assert name in modules
    code = ("import importlib, json, sys\n"
            f"for name in {modules!r}:\n"
            "    importlib.import_module(name)\n"
            "print(json.dumps(sorted(m for m in sys.modules\n"
            "                        if m.split('.')[0] in ('jax', 'flax'))))\n")
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
                        assert top not in ("jax", "flax"), (name, mod)
                        assert not mod.startswith((
                            "commu_tpu.generation", "commu_tpu.models",
                            "commu_tpu.ops", "commu_tpu.training",
                            "commu_tpu.parallel")), (name, mod)


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
