"""The unfused attention path's primitives (``commu_tpu_torch.ops.
rel_attention``) against ``commu_tpu.ops.rel_attention``: plain torch
against plain JAX on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commu_tpu.ops import rel_attention as jrel
from commu_tpu_torch.ops import rel_attention as trel


@pytest.mark.parametrize("shape", [(2, 3, 5, 9), (1, 2, 4, 4), (3, 1, 7, 23)])
def test_rel_shift_matches_jax(shape):
    x = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    ours = trel.rel_shift(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jrel.rel_shift(
        jnp.asarray(x))))


@pytest.mark.parametrize("clamp_len", [-1, 0, 3])
@pytest.mark.parametrize("klen,d_model", [(24, 32), (7, 10), (1152, 500)])
def test_relative_position_embedding_matches_jax(clamp_len, klen, d_model):
    ours = trel.relative_position_embedding(klen, d_model,
                                            clamp_len=clamp_len).numpy()
    ref = np.asarray(jrel.relative_position_embedding(
        klen, d_model, jnp.float32, clamp_len))
    assert ours.shape == (klen, d_model)
    # sin/cos of f32 angles up to klen - 1 radians, whose inverse
    # frequencies (a pow) may round apart by an ulp: two ulps of the
    # largest angle
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=2 * max(klen - 1, 1) * 2.0 ** -23)
    if clamp_len > 0:  # the distances past clamp_len share one row
        np.testing.assert_array_equal(ours[:klen - clamp_len],
                                      ours[:1].repeat(klen - clamp_len, 0))


def test_relative_position_embedding_casts_to_the_dtype():
    ours = trel.relative_position_embedding(16, 8, torch.bfloat16)
    ref = trel.relative_position_embedding(16, 8).to(torch.bfloat16)
    assert ours.dtype == torch.bfloat16
    torch.testing.assert_close(ours, ref, rtol=0, atol=0)


@pytest.mark.parametrize("same_length", [False, True])
@pytest.mark.parametrize("with_reset", [False, True])
@pytest.mark.parametrize("tgt_len,mem_capacity", [(4, 8), (6, 6), (5, 0)])
def test_build_attention_mask_matches_jax_over_every_count(
        same_length, with_reset, tgt_len, mem_capacity):
    batch = 3
    reset = np.array([False, True, False]) if with_reset else None
    for mem_count in range(mem_capacity + 1):
        ours = trel.build_attention_mask(
            tgt_len, mem_capacity, mem_count,
            None if reset is None else torch.from_numpy(reset), same_length,
            batch)
        ref = jrel.build_attention_mask(
            tgt_len, mem_capacity, jnp.int32(mem_count),
            None if reset is None else jnp.asarray(reset), same_length, batch)
        assert ours.dtype == torch.bool
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref),
                                      err_msg=f"mem_count {mem_count}")
