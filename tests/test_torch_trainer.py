"""The port's ``Trainer.train``, ``final_test``, resume, train CLI and
checkpoints, on the CPU.

A tiny seeded corpus is written with ``save_corpus``.  The checkpoints are
the reference's ``.pt`` layout: the JAX package's ``import_torch`` reads
them, and the port's serving CLI answers a request from one.
"""
import io
import json
import logging

import jax
import numpy as np
import pytest
import torch

from commu_tpu.config import (EvaluateConfig, ModelConfig, TrainConfig,
                              TrainingConfig)
from commu_tpu.data.dataset import save_corpus
from commu_tpu_torch import train as train_cli
from commu_tpu_torch.generation.postprocess import read_midi
from commu_tpu_torch.training import Trainer

MODEL = ModelConfig(num_layers=2, num_heads=2, units=32, inner_size=48,
                    dropout=0.0, attention_dropout=0.0)
CFG = TrainingConfig(
    model=MODEL,
    train=TrainConfig(batch_size=4, batch_chunk=2, tgt_length=16,
                      mem_length=32, warmup_step=2, max_step=4,
                      log_interval=2, eval_interval=2),
    evaluate=EvaluateConfig(batch_size=3, tgt_length=16, mem_length=32),
)
OVERRIDES = ["model.num_layers=2", "model.num_heads=2", "model.units=32",
             "model.inner_size=48", "model.dropout=0.0",
             "model.attention_dropout=0.0", "train.batch_size=4",
             "train.batch_chunk=2", "train.tgt_length=16",
             "train.mem_length=32", "train.warmup_step=2",
             "train.log_interval=2", "train.eval_interval=2",
             "evaluate.batch_size=3", "evaluate.tgt_length=16",
             "evaluate.mem_length=32"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    rng = np.random.RandomState(0)

    def seqs(n):
        metas = [rng.randint(560, 729, size=11).astype(np.int64)
                 for _ in range(n)]
        events = [rng.randint(2, 560, size=rng.randint(20, 90))
                  .astype(np.int64) for _ in range(n)]
        return metas, events

    d = tmp_path_factory.mktemp("corpus") / "npy"
    save_corpus(d, "train", *seqs(12))
    save_corpus(d, "val", *seqs(5))
    return d


def test_train_final_test_and_resume(corpus, tmp_path, caplog):
    work = tmp_path / "work"
    trainer = Trainer(str(corpus), CFG, device="cpu",
                      model_dtype=torch.float32, work_dir=str(work))
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    with caplog.at_level(logging.INFO, logger="ComMU"):
        trainer.train()
        test_nll = trainer.final_test()
    text = caplog.text
    assert text.count("Train Step") == 2 and "Train Step 4/4, lr=" in text
    assert text.count("Eval step") == 2 and "Test step" in text
    assert "End of training" in text and np.isfinite(test_nll)
    assert (work / "config.yml").is_file()
    for name in ("checkpoint_last", "checkpoint_best"):
        assert (work / f"{name}.pt").is_file()
    blob = torch.load(work / "checkpoint_last.pt", weights_only=False)
    assert blob["train_step"] == 4 and set(blob) == {
        "model", "optimizer", "scheduler", "train_step", "best_val_nll",
        "vocab", "amp"}
    moved = [k for k, v in trainer.model.state_dict().items()
             if not torch.equal(v, before[k])]
    assert moved  # the steps trained something

    # resume: weights, Adam moments and the schedule come back; a second
    # trainer then continues from step 4
    trained = trainer.model.state_dict()
    again = Trainer(str(corpus), CFG, device="cpu",
                    model_dtype=torch.float32, work_dir=str(work))
    assert again.maybe_resume() and again.step == 4
    last = torch.load(work / "checkpoint_last.pt", weights_only=False)
    for key, value in again.model.state_dict().items():
        torch.testing.assert_close(value, last["model"][key], rtol=0, atol=0)
    opt = again._train_state()[0]
    assert opt.state_dict()["state"][0]["step"] == 4
    assert again._scheduler.last_epoch == 4
    again.train(max_step=6)
    assert again.step == 6
    assert set(trained) == set(again.model.state_dict())


def test_checkpoint_reads_in_jax_and_serves(corpus, tmp_path):
    """``import_torch`` (JAX package) reads the port's checkpoint_best.pt
    with the same parameters, and ``python -m commu_tpu_torch.generate``
    serves a request from it: the trained model reaches the serving path."""
    from commu_tpu.training.checkpoint import import_torch
    from commu_tpu_torch import generate
    from commu_tpu_torch.models import state_dict_from_flax_params

    work = tmp_path / "work"
    trainer = Trainer(str(corpus), CFG, device="cpu",
                      model_dtype=torch.float32, work_dir=str(work))
    trainer.train(max_step=2)
    best = work / "checkpoint_best.pt"
    params = import_torch(best, MODEL)
    back = state_dict_from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), MODEL)
    saved = torch.load(best, weights_only=False)["model"]
    for key, value in back.items():
        torch.testing.assert_close(value, saved[key], rtol=0, atol=0)
    for key, value in trainer.model.state_dict().items():
        torch.testing.assert_close(value, saved[key], rtol=0, atol=0)

    request = {"bpm": 70, "audio_key": "aminor", "time_signature": "4/4",
               "pitch_range": "mid", "num_measures": 4.0,
               "inst": "acoustic_piano", "genre": "newage",
               "min_velocity": 60, "max_velocity": 80,
               "track_role": "main_melody", "rhythm": "standard",
               "request_id": "trained", "chord_progression": "-".join(
                   ["c"] * 32)}
    out = io.StringIO()
    generate.main(["--device", "cpu", "--serve", "--lenient",
                   "--gen_length", "48", "--checkpoint_dir", str(best),
                   "--output_dir", str(tmp_path / "out")],
                  stdin=io.StringIO(json.dumps(request) + "\n"), stdout=out)
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    assert lines[0]["status"] == "ready" and lines[1]["ok"], lines
    for path in lines[1]["files"]:
        read_midi(path)


def test_train_cli_in_process(corpus, tmp_path):
    work = train_cli.main(
        ["--data_dir", str(corpus), "--work_dir", str(tmp_path / "runs"),
         "--device", "cpu", "--dtype", "float32", "--max_step", "2",
         "--precise_bd"] + [a for o in OVERRIDES for a in ("--set", o)])
    assert (tmp_path / "runs").is_dir() and work.startswith(
        str(tmp_path / "runs"))
    log = (tmp_path / "runs").glob("*/train.log")
    text = next(log).read_text()
    assert "Train Step 2/2" in text and "End of training | test nll" in text
    # --resume continues in the same work dir
    train_cli.main(["--data_dir", str(corpus), "--work_dir", work,
                    "--device", "cpu", "--dtype", "float32", "--max_step",
                    "4", "--resume"] + [a for o in OVERRIDES
                                        for a in ("--set", o)])
    assert "Resumed from step 2" in open(f"{work}/train.log").read()


# (flags, what the refusal names); the "--profile" case was a refusal until
# the flag was ported, and now runs: 11 steps, a trace of steps 4-10.  The
# data-parallel flags were refusals until they were ported too: now the
# CLI refuses more ranks than CUDA devices (naming both counts), and the
# rendezvous flags without --distributed or --distributed without them.
@pytest.mark.parametrize("flags,needle", [
    (["--device", "cuda", "--num_devices", "2"],
     "--num_devices 2: .* 2 CUDA devices, and this machine has 1"),
    (["--distributed"], "--distributed needs --coordinator_address"),
    (["--num_processes", "2"], "take --distributed"),
    (["--profile"], "--profile"),
    (["--coordinator_address", "host:1"], "take --distributed"),
])
def test_train_cli_refuses_what_is_not_ported(corpus, tmp_path, monkeypatch,
                                              flags, needle):
    if "--num_devices" in flags:  # a machine with one CUDA device
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    if flags == ["--profile"]:
        work = train_cli.main(
            ["--data_dir", str(corpus), "--work_dir", str(tmp_path / "runs"),
             "--device", "cpu", "--dtype", "float32", "--max_step", "11"]
            + flags + [a for o in OVERRIDES for a in ("--set", o)])
        text = open(f"{work}/train.log").read()
        assert "profiler trace written to" in text
        assert "Train Step 10/11" in text and "End of training" in text
        trace = f"{work}/profile/trace_steps_4_10.json"
        with open(trace) as fh:
            assert json.load(fh)["traceEvents"]
        return
    with pytest.raises(SystemExit, match=needle):
        train_cli.main(["--data_dir", str(tmp_path), "--work_dir",
                        str(tmp_path / "w"), "--device", "cpu"] + flags)


def test_train_cli_trains_at_the_default_dropout_and_resume_continues_seeds(
        corpus, tmp_path, monkeypatch):
    """No ``--set model.dropout``: ``ModelConfig()``'s 0.1 and 0.1 train.
    Every step draws from the generator of (seed, step), so the resumed run
    asks for steps 2 and 3, not 0 and 1 again."""
    from commu_tpu_torch.training import step as step_mod

    asked = []
    real = step_mod.step_generator

    def recording(seed, step, rank=0):
        asked.append((seed, step))
        assert rank == 0  # one process: rank 0's stream
        return real(seed, step, rank)

    monkeypatch.setattr(step_mod, "step_generator", recording)
    overrides = [o for o in OVERRIDES if "dropout" not in o]
    flags = ["--data_dir", str(corpus), "--device", "cpu", "--dtype",
             "float32"] + [a for o in overrides for a in ("--set", o)]
    work = train_cli.main(flags + ["--work_dir", str(tmp_path / "runs"),
                                   "--max_step", "2"])
    text = open(f"{work}/train.log").read()
    assert "Train Step 2/2" in text and "End of training | test nll" in text
    assert "dropout: 0.1" in open(f"{work}/config.yml").read()
    nll = float(text.split("End of training | test nll")[1].split("|")[0])
    assert np.isfinite(nll)
    assert asked == [(1111, 0), (1111, 1)]
    train_cli.main(flags + ["--work_dir", work, "--max_step", "4",
                            "--resume"])
    assert asked == [(1111, i) for i in range(4)]
    assert "Resumed from step 2" in open(f"{work}/train.log").read()


LEVERS = ("COMMU_BD_INT8", "COMMU_BD_INT8_BWD", "COMMU_DROPOUT_BITS")
DROP_FLAGS = [a for o in OVERRIDES if "dropout" not in o
              for a in ("--set", o)] + ["--set", "train.eval_interval=3",
                                        "--max_step", "3"]


def _cli(corpus, work_dir, *flags):
    return train_cli.main(["--data_dir", str(corpus), "--work_dir",
                           str(work_dir), "--device", "cpu", "--dtype",
                           "float32", *DROP_FLAGS, *flags])


def _weights(corpus, work):
    """The weights of ``work``'s checkpoint_last, through the resume path."""
    from commu_tpu_torch.config import get_default_cfg_training

    cfg = train_cli.apply_overrides(
        get_default_cfg_training(),
        [o for o in OVERRIDES if "dropout" not in o]
        + ["train.eval_interval=3"])
    trainer = Trainer(str(corpus), cfg, device="cpu",
                      model_dtype=torch.float32, work_dir=work)
    assert trainer.maybe_resume() and trainer.step == 3
    return trainer.model.state_dict(), cfg


def test_train_cli_default_is_the_fast_mode_and_restores_the_environment(
        corpus, tmp_path, monkeypatch):
    """Without ``--precise_bd`` the CLI trains and tests with the
    reference's three levers, as the root ``train.py`` does, and leaves
    ``os.environ`` as it found it: a variable left set would switch the
    kernels of every later caller in the process."""
    import os

    for name in LEVERS:
        monkeypatch.delenv(name, raising=False)
    seen = []
    real_train, real_test = Trainer.train, Trainer.final_test

    def spy_train(self, *args, **kwargs):
        seen.append(tuple(os.environ.get(name) for name in LEVERS))
        return real_train(self, *args, **kwargs)

    def spy_test(self):
        seen.append(tuple(os.environ.get(name) for name in LEVERS))
        return real_test(self)

    monkeypatch.setattr(Trainer, "train", spy_train)
    monkeypatch.setattr(Trainer, "final_test", spy_test)
    work = _cli(corpus, tmp_path / "fast")
    assert seen == [("1", "1", "8")] * 2
    assert all(name not in os.environ for name in LEVERS)
    text = open(f"{work}/train.log").read()
    assert "numerics: COMMU_BD_INT8=1, COMMU_BD_INT8_BWD=1, " \
        "COMMU_DROPOUT_BITS=8" in text
    assert "Train Step 2/3" in text and "End of training | test nll" in text
    assert "nan" not in text.lower()

    # an exported value wins over the fast default, and stays as exported
    seen.clear()
    monkeypatch.setenv("COMMU_BD_INT8", "0")
    _cli(corpus, tmp_path / "mixed")
    assert seen == [("0", "1", "8")] * 2
    assert os.environ["COMMU_BD_INT8"] == "0"
    assert "COMMU_BD_INT8_BWD" not in os.environ

    # --precise_bd overrides an exported lever, and puts it back
    seen.clear()
    monkeypatch.setenv("COMMU_DROPOUT_BITS", "8")
    _cli(corpus, tmp_path / "precise", "--precise_bd")
    assert seen == [("0", "0", "16")] * 2
    assert os.environ["COMMU_DROPOUT_BITS"] == "8"


def test_precise_bd_is_the_exact_mode_bit_for_bit(corpus, tmp_path,
                                                  monkeypatch):
    """``--precise_bd`` computes what the port computed before it had the
    fast mode, which is what ``Trainer`` computes with no lever set: every
    parameter after 3 steps at dropout 0.1 is equal bit for bit.  The fast
    mode's are not."""
    for name in LEVERS:
        monkeypatch.delenv(name, raising=False)
    precise, cfg = _weights(corpus, _cli(corpus, tmp_path / "p",
                                         "--precise_bd"))
    trainer = Trainer(str(corpus), cfg, device="cpu",
                      model_dtype=torch.float32,
                      work_dir=str(tmp_path / "direct"))
    trainer.train(max_step=3)
    direct = trainer.model.state_dict()
    assert precise.keys() == direct.keys()
    for key, value in direct.items():
        assert torch.equal(precise[key], value), key
    fast, _ = _weights(corpus, _cli(corpus, tmp_path / "f"))
    assert any(not torch.equal(fast[key], direct[key]) for key in direct)


@pytest.mark.parametrize("name,value,needle", [
    ("COMMU_DROPOUT_BITS", "4", "8 or 16"),
    ("COMMU_INT8_DQ", "1", "COMMU_INT8_DQ=1"),
    ("COMMU_INT8_DK", "1", "COMMU_INT8_DK=1"),
    ("COMMU_SOFTMAX", "clamp", "COMMU_SOFTMAX=clamp"),
    ("COMMU_DEFER_NORM", "1", "COMMU_DEFER_NORM=1"),
    ("COMMU_SCALE_HOIST", "1", "COMMU_SCALE_HOIST=1"),
])
def test_train_cli_refuses_variables_it_cannot_honour(tmp_path, monkeypatch,
                                                      name, value, needle):
    import os

    for lever in LEVERS:
        monkeypatch.delenv(lever, raising=False)
    monkeypatch.setenv(name, value)
    with pytest.raises(SystemExit, match=needle):
        train_cli.main(["--data_dir", str(tmp_path), "--work_dir",
                        str(tmp_path / "w"), "--device", "cpu"])
    assert os.environ[name] == value
    assert all(lever not in os.environ for lever in LEVERS if lever != name)
    # the values that switch nothing on pass the check
    monkeypatch.setenv(name, "16" if name == "COMMU_DROPOUT_BITS" else
                       "max" if name == "COMMU_SOFTMAX" else "0")
    train_cli.check_environment()


def test_trainer_refuses_the_reference_positional_work_dir(corpus, tmp_path):
    """The reference's order is (data_dir, work_dir, cfg); here the config
    comes second and ``work_dir`` is a keyword."""
    with pytest.raises(TypeError, match="work_dir= by keyword"):
        Trainer(str(corpus), str(tmp_path / "w"))
    with pytest.raises(TypeError, match="work_dir= by keyword"):
        Trainer(str(corpus), tmp_path / "w", device="cpu")
    with pytest.raises(TypeError):   # Python's own: too many positionals
        Trainer(str(corpus), str(tmp_path / "w"), CFG)
    assert "(data_dir, work_dir, cfg," in " ".join(Trainer.__doc__.split())


def test_apply_overrides_types():
    cfg = train_cli.apply_overrides(
        TrainingConfig(), ["train.batch_size=16", "model.same_length=true",
                           "train.lr=0.001"])
    assert cfg.train.batch_size == 16 and cfg.model.same_length is True
    assert cfg.train.lr == 0.001
    with pytest.raises(AttributeError):
        train_cli.apply_overrides(TrainingConfig(), ["train.nope=1"])
