"""The port's ``Trainer.evaluate`` against the JAX package's, on the CPU.

A tiny seeded corpus is written with ``save_corpus`` (as
tests/test_eval_parity.py builds one); the JAX trainer's initial parameters
cross into the port through ``state_dict_from_flax_params``.  The JAX side
runs its CPU default path (XLA), whose agreement with its kernel path over
memory tests/test_fused_attention.py holds; the port runs its kernel path's
plain twins.  The sequences are long enough for the ring to wrap.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commu_tpu.config import (EvaluateConfig, ModelConfig, TrainConfig,
                              TrainingConfig)
from commu_tpu.data.dataset import save_corpus
from commu_tpu_torch.models import state_dict_from_flax_params
from commu_tpu_torch.training import Trainer
import torch_cpu_threads  # noqa: F401  (one intra-op thread)

CFG = TrainingConfig(
    model=ModelConfig(num_layers=2, num_heads=2, units=32, inner_size=48,
                      dropout=0.0, attention_dropout=0.0),
    train=TrainConfig(batch_size=4, batch_chunk=2, tgt_length=16,
                      mem_length=32),
    evaluate=EvaluateConfig(batch_size=3, tgt_length=16, mem_length=32),
)


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
    save_corpus(d, "train", *seqs(8))
    save_corpus(d, "val", *seqs(7))
    return d


# f32: the repo's forward tolerance.  bf16: the JAX XLA path and the port's
# kernel path round at different points (the XLA path scores through a
# rel-shifted bf16 table, the kernel path through bf16 phi . psi), so
# per-token NLLs differ by bf16 flips that mostly cancel in the sum; with
# the trainer's small initial weights the totals differ by ~1e-6, and 1e-3
# leaves room for larger activations.
@pytest.mark.parametrize("dtype,rtol", [("float32", 2e-4),
                                        ("bfloat16", 1e-3)])
def test_evaluate_matches_jax_trainer(corpus, tmp_path, dtype, rtol):
    from commu_tpu.training.loop import Trainer as JaxTrainer

    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jtrainer = JaxTrainer(str(corpus), str(tmp_path / "work"), CFG,
                          num_devices=1, model_dtype=jdt)
    ref_tokens, ref_nll = jtrainer.evaluate("valid")

    trainer = Trainer(str(corpus), CFG, device="cpu", model_dtype=tdt)
    params = jax.tree_util.tree_map(np.asarray, jtrainer.state.params)
    trainer.model.load_state_dict(state_dict_from_flax_params(params,
                                                              CFG.model))
    tokens, nll = trainer.evaluate("valid")
    assert tokens == ref_tokens == trainer.dataset.num_tokens("valid")
    np.testing.assert_allclose(nll, ref_nll, rtol=rtol)


def test_init_is_seeded_and_evaluate_is_deterministic(corpus):
    a = Trainer(str(corpus), CFG, device="cpu", model_dtype=torch.float32)
    b = Trainer(str(corpus), CFG, device="cpu", model_dtype=torch.float32,
                generator=torch.Generator().manual_seed(CFG.train.seed))
    for (name, pa), pb in zip(a.model.named_parameters(),
                              b.model.parameters()):
        assert pa.dtype == torch.float32, name  # parameters stay f32
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=name)
    tokens, nll = a.evaluate("valid")
    assert (tokens, nll) == b.evaluate("test")  # "test" IS the val split
    assert np.isfinite(nll) and tokens > 0
    # an untrained model is near uniform over the 729-token vocabulary
    assert abs(nll / tokens - np.log(729)) < 0.1
