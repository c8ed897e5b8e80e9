"""``Trainer(profile=True)`` and ``ops._build.span`` on the CPU: the trace
of steps [start + 4, start + 10) lands in ``work_dir/profile/`` as a Chrome
trace, also after a resume, and names the clip and the optimizer step."""
import dataclasses
import json
import logging

import numpy as np
import pytest
import torch

from commu_tpu_torch.data.dataset import save_corpus
from commu_tpu_torch.ops import _build
from commu_tpu_torch.training import Trainer

from test_torch_trainer import CFG
import torch_cpu_threads  # noqa: F401  (one intra-op thread)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    rng = np.random.RandomState(2)

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


def _trace(work_dir, name):
    path = work_dir / "profile" / name
    assert path.is_file(), sorted((work_dir / "profile").iterdir())
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


def _names(events, prefix):
    return [e["name"] for e in events if e.get("name", "").startswith(prefix)]


def test_trainer_profile_traces_steps_4_to_10(corpus, tmp_path, caplog,
                                              monkeypatch):
    # caplog reads the root logger: an in-process train CLI run earlier in
    # this worker (configure_logging) leaves "ComMU" unpropagated
    monkeypatch.setattr(logging.getLogger("ComMU"), "propagate", True)
    cfg = CFG.replace(train=dataclasses.replace(
        CFG.train, eval_interval=1000, log_interval=4))
    trainer = Trainer(str(corpus), cfg, device="cpu",
                      model_dtype=torch.float32, work_dir=str(tmp_path),
                      profile=True)
    with caplog.at_level(logging.INFO, logger="ComMU"):
        trainer.train(max_step=11)
    assert trainer.step == 11
    assert [p.name for p in (tmp_path / "profile").iterdir()] == [
        "trace_steps_4_10.json"]
    events = _trace(tmp_path, "trace_steps_4_10.json")
    # one clip a step, and Adam's step, inside the window only
    assert _names(events, "commu::clip") == ["commu::clip"] * 6
    assert len(_names(events, "Optimizer.step#Adam.step")) == 6
    assert "profiler trace written to" in caplog.text


def test_trainer_profile_after_a_resume(corpus, tmp_path):
    trainer = Trainer(str(corpus), CFG, device="cpu",
                      model_dtype=torch.float32, work_dir=str(tmp_path))
    trainer.train(max_step=2)  # eval_interval 2: checkpoint_last at step 2
    assert not (tmp_path / "profile").exists()
    resumed = Trainer(str(corpus), CFG, device="cpu",
                      model_dtype=torch.float32, work_dir=str(tmp_path),
                      profile=True)
    assert resumed.maybe_resume() and resumed.step == 2
    resumed.train(max_step=12)
    events = _trace(tmp_path, "trace_steps_6_12.json")
    assert _names(events, "commu::clip") == ["commu::clip"] * 6


def test_a_run_that_ends_inside_the_window_keeps_its_trace(corpus, tmp_path):
    trainer = Trainer(str(corpus), CFG, device="cpu",
                      model_dtype=torch.float32, work_dir=str(tmp_path),
                      profile=True)
    trainer.train(max_step=6)
    events = _trace(tmp_path, "trace_steps_4_6.json")
    assert _names(events, "commu::clip") == ["commu::clip"] * 2


def test_span_is_a_trace_range_only_under_a_profiler():
    assert not isinstance(_build.span("x"), torch.profiler.record_function)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with _build.span("ring_write_layer"):
            torch.ones(3).sum()
    names = {e.name for e in prof.events()}
    assert "commu::ring_write_layer" in names
