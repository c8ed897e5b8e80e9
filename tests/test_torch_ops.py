"""The PyTorch port's ops against the JAX package's, on the CPU.

Inputs come from numpy with a fixed seed and go through both functions.  The
JAX side runs its Pallas kernels in interpreter mode (as its own tests do)
and ``cache_append`` through its jnp branch; the port's wrappers run their
plain PyTorch twins (the tensors are on the CPU).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commu_tpu.ops import fused_attention as jfa
from commu_tpu.ops import layout as jlayout
from commu_tpu.ops.fused_ffn import ffn_block as jffn_block
from commu_tpu_torch.ops import fused_attention as tfa
from commu_tpu_torch.ops import layout as tlayout
from commu_tpu_torch.ops.fused_ffn import ffn_block as tffn_block
import torch_cpu_threads  # noqa: F401  (one intra-op thread)

# summation order differs between the frameworks
RTOL, ATOL = 1e-4, 1e-5
D_MODEL, HEADS = 32, 2
D_HEAD = D_MODEL // HEADS


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


@pytest.mark.parametrize("t,m_cap", [(11, 0), (8, 24)])
def test_trig_tables(t, m_cap):
    np.testing.assert_allclose(
        tfa.query_trig_table(t, m_cap, D_MODEL, dtype=torch.float32).numpy(),
        np.asarray(jfa.query_trig_table(t, m_cap, D_MODEL, dtype=jnp.float32)),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tfa.key_trig_basis(m_cap + t, D_MODEL, dtype=torch.float32).numpy(),
        np.asarray(jfa.key_trig_basis(m_cap + t, D_MODEL, dtype=jnp.float32)),
        rtol=0, atol=1e-6)
    assert tfa._fpad(500) == jfa._fpad(500) == 256
    np.testing.assert_allclose(tfa._inv_freq(500).numpy(),
                               np.asarray(jfa._inv_freq(500)), rtol=1e-6)


@pytest.mark.parametrize("same_length", [False, True])
@pytest.mark.parametrize("t,m_cap,count,head", [(8, 0, 0, 0), (8, 24, 16, 16),
                                                (8, 24, 24, 8)])
def test_build_mask_bias_exact(t, m_cap, count, head, same_length):
    ours = tfa.build_mask_bias(t, m_cap, count, head, same_length)
    ref = jfa.build_mask_bias(t, m_cap, jnp.int32(count), jnp.int32(head),
                              same_length)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_array_equal(ours.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_pack_r_kernel_and_scaled_biases():
    rng = np.random.default_rng(0)
    r_kernel = rng.normal(size=(D_MODEL, D_MODEL)).astype(np.float32)
    np.testing.assert_array_equal(
        tfa.pack_r_kernel(_t(r_kernel), HEADS).numpy(),
        np.asarray(jfa.pack_r_kernel(jnp.asarray(r_kernel), HEADS)))
    rwb, rrb = (rng.normal(size=(HEADS, D_HEAD)).astype(np.float32)
                for _ in range(2))
    ours = tfa._scaled_biases(_t(rwb), _t(rrb), 0.25, torch.float32)
    ref = jfa._scaled_biases(jnp.asarray(rwb), jnp.asarray(rrb), 0.25,
                             jnp.float32)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("same_length", [False, True])
@pytest.mark.parametrize("t", [5, 11])
def test_attention_matches_jax(t, same_length):
    rng = np.random.default_rng(t)
    b = 3
    q, k, v = (rng.normal(size=(b, HEADS, D_HEAD, t)).astype(np.float32)
               for _ in range(3))
    r_kernel = (rng.normal(size=(D_MODEL, D_MODEL)) * 0.3).astype(np.float32)
    rwb, rrb = (rng.normal(size=(HEADS, D_HEAD)).astype(np.float32) * 0.1
                for _ in range(2))
    reset = np.array([False, True, False])
    scale = 1.0 / D_HEAD ** 0.5

    ref = jfa.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jfa.pack_r_kernel(jnp.asarray(r_kernel), HEADS),
        jfa.key_trig_basis(t, D_MODEL, jnp.float32), jnp.asarray(rwb),
        jnp.asarray(rrb), jnp.asarray(reset), d_model=D_MODEL, scale=scale,
        same_length=same_length)
    ours = tfa.attention(
        _t(q), _t(k), _t(v), tfa.pack_r_kernel(_t(r_kernel), HEADS),
        tfa.key_trig_basis(t, D_MODEL, torch.float32), _t(rwb), _t(rrb),
        torch.from_numpy(reset), d_model=D_MODEL, scale=scale,
        same_length=same_length)
    assert ours.shape == (b, HEADS, D_HEAD, t) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def test_ffn_block_matches_jax():
    rng = np.random.default_rng(3)
    b, d, f, t = 4, D_MODEL, 48, 11
    x, o = (rng.normal(size=(b, d, t)).astype(np.float32) for _ in range(2))
    w1 = (rng.normal(size=(d, f)) * 0.2).astype(np.float32)
    w2 = (rng.normal(size=(f, d)) * 0.2).astype(np.float32)
    b1 = rng.normal(size=f).astype(np.float32) * 0.1
    b2, be1, be2 = (rng.normal(size=d).astype(np.float32) * 0.1
                    for _ in range(3))
    g1, g2 = (1.0 + rng.normal(size=d).astype(np.float32) * 0.1
              for _ in range(2))
    args = (x, o, w1, b1, w2, b2, g1, be1, g2, be2)
    ref = jffn_block(*map(jnp.asarray, args), jnp.int32(0), 0.0, False)
    ours = tffn_block(*map(_t, args))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_cache_append_exact(dtype):
    """No-advance row, a row at capacity (never writes) and block-crossing
    lengths, as tests/test_decode.py pins for the JAX kernel."""
    rng = np.random.default_rng(7)
    l_dim, g_dim, h, dh, m_cap = 2, 5, 3, 5, 256
    k, v = (rng.normal(size=(l_dim, g_dim, h, dh, m_cap)).astype(dtype)
            for _ in range(2))
    k_self, v_self = (rng.normal(size=(l_dim, g_dim, h, dh)).astype(dtype)
                      for _ in range(2))
    length = np.array([0, 129, m_cap, 255, m_cap - 1], np.int32)
    advance = np.array([True, True, True, False, True])

    ref_k, ref_v = jlayout.cache_append(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(k_self),
        jnp.asarray(v_self), jnp.asarray(length), jnp.asarray(advance))

    def tt(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32)

    tk, tv = tt(k), tt(v)
    out_k, out_v = tlayout.cache_append(tk, tv, tt(k_self), tt(v_self),
                                        torch.from_numpy(length),
                                        torch.from_numpy(advance))
    assert out_k is tk and out_v is tv  # in place
    np.testing.assert_array_equal(out_k.float().numpy(),
                                  np.asarray(ref_k.astype(jnp.float32)))
    np.testing.assert_array_equal(out_v.float().numpy(),
                                  np.asarray(ref_v.astype(jnp.float32)))
    np.testing.assert_array_equal(out_k[:, 2].float().numpy(),
                                  np.asarray(k[:, 2], np.float32))


def test_library_without_nvcc_raises(tmp_path, monkeypatch):
    """No fallback: a kernel library that cannot be built raises, so a CUDA
    tensor reaching a wrapper never silently runs the plain version."""
    from commu_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library()
    assert _build._lib is None


def test_wrappers_dispatch_cpu_to_plain_and_reject_mixed_devices():
    from commu_tpu_torch.ops import _build

    _build.reset_launches()
    x = torch.zeros(2, 3)
    assert not _build.use_kernel(x, x)
    with pytest.raises(ValueError):
        _build.use_kernel(x, torch.zeros(2, 3, device="meta"))
    test_cache_append_exact(np.float32)
    assert _build.LAUNCHES == {k: 0 for k in _build.LAUNCHES}
