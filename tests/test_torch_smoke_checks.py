"""``chip_smoke.py``'s gradient attribution and data-parallel weight check,
on the CPU at small sizes (the card runs them at ``TrainConfig()``).

- ``grad_attribution``: the train step's first two windows on the kernel
  path (the twins, here) and the unfused path, f32 and bf16, against the
  unfused path in f64 from the same weights; in f32 both stay within a
  few float32 roundings of f64;
- ``_held_weights``: two checkpoints of ``ModelConfig()`` runs: equal ones
  read 0; an element moved where Adam's second moment is large is
  reported, one where it is near zero is left out of the held share, and
  the per-tensor ratio is taken against the seeded weights.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from commu_tpu_torch.config import ModelConfig, TrainConfig
from commu_tpu_torch.models import VOCAB_SIZE, TransformerXL


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(6)
    chip_smoke.write_corpus(path, [400, 480], seed=7,
                            train_lengths=rng.randint(300, 900, size=20))
    return path


def test_grad_attribution_on_the_cpu(corpus, capsys):
    readings = chip_smoke.grad_attribution(corpus, "cpu", ((32, 4, 64),),
                                           device="cpu")
    out = capsys.readouterr().out
    assert out.count("[grads] units 32 heads 4 (dh 8)") == 4  # 2 dtypes x 2
    assert "pos_ff.CoreNet.*.weight" in out
    assert set(readings) == {(32, 4, d, p) for d in ("float32", "bfloat16")
                             for p in ("kernel", "unfused")}
    assert readings[(32, 4, "float32", "unfused")] < 1e-6
    assert readings[(32, 4, "float32", "kernel")] < 1e-5
    assert 0 < readings[(32, 4, "bfloat16", "kernel")] < 2e-2


def _checkpoint(path, model, v_scale):
    """A checkpoint of ``model`` with Adam's state: exp_avg_sq
    ``v_scale[name]`` where given, else 1e-6 everywhere."""
    params = list(model.named_parameters())
    state = {i: {"step": torch.tensor(4.0), "exp_avg": torch.zeros_like(p),
                 "exp_avg_sq": (v_scale[n] if n in v_scale else
                                torch.full_like(p, 1e-6))}
             for i, (n, p) in enumerate(params)}
    torch.save({"model": {k: v.detach().clone() for k, v in
                          model.state_dict().items()},
                "optimizer": {"state": state, "param_groups": []}}, path)


def test_held_weights(tmp_path):
    model = TransformerXL(VOCAB_SIZE, ModelConfig())
    model.init_parameters(torch.Generator().manual_seed(TrainConfig().seed))
    with torch.no_grad():  # the run's update: every weight moved by 1e-3
        for p in model.parameters():
            p.add_(1e-3)
    name = "layers.0.pos_ff.CoreNet.0.weight"
    v = torch.full_like(dict(model.named_parameters())[name], 1e-6)
    v[0, 0] = 1e-14  # a gradient near zero
    _checkpoint(tmp_path / "a.pt", model, {name: v})
    held, worst, _, ratio, _ = chip_smoke._held_weights(
        tmp_path / "a.pt", tmp_path / "a.pt", 4)
    assert worst == 0.0 and ratio == 0.0
    assert all(dw == 0.0 for dw, _ in held.values())
    assert 0.99 < held[0.1][1] < 1.0  # all but the near-zero element

    with torch.no_grad():  # the other run: that element, then another
        w = dict(model.named_parameters())[name]
        w[0, 0] += 5e-4
    _checkpoint(tmp_path / "b.pt", model, {name: v})
    held, worst, key, ratio, ratio_key = chip_smoke._held_weights(
        tmp_path / "a.pt", tmp_path / "b.pt", 4)
    assert worst == pytest.approx(5e-4, rel=1e-3) and key == name
    assert held[0.1][0] == 0.0  # left out: its gradient is near zero
    with torch.no_grad():
        w[0, 1] += 5e-4
    _checkpoint(tmp_path / "b.pt", model, {name: v})
    held, _, _, ratio, ratio_key = chip_smoke._held_weights(
        tmp_path / "a.pt", tmp_path / "b.pt", 4)
    assert held[0.1][0] == pytest.approx(5e-4, rel=1e-3)
    assert ratio_key == name
    assert ratio == pytest.approx(5e-4 * 2 ** 0.5 / (1e-3 * w.numel() ** 0.5),
                                  rel=1e-2)
