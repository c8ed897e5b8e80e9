"""The port's XL-memory ops against the JAX package's, on the CPU.

``ring_psi``, ``project_mem_kv``, ``attention_mem``, ``ring_write_layer`` and
``fused_token_nll``: inputs come from numpy with a fixed seed and go through
both functions.  The JAX side runs its Pallas kernels in interpreter mode
(``ring_write_layer`` through its interpret branch), as its own tests do;
the port's wrappers run their plain PyTorch twins (the tensors are on the
CPU).  bf16 inputs are the same f32 numbers rounded once on each side.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commu_tpu.ops import fused_attention as jfa
from commu_tpu.ops import layout as jlayout
from commu_tpu.ops.fused_nll import fused_token_nll as jnll
from commu_tpu_torch.ops import fused_attention as tfa
from commu_tpu_torch.ops import layout as tlayout
from commu_tpu_torch.ops.fused_nll import fused_token_nll as tnll

D_MODEL, HEADS = 32, 2
D_HEAD = D_MODEL // HEADS
T, R = 8, 4          # window, ring slabs of T: M = 32
M = R * T
L1, B = 3, 3         # ring streams (L + 1), batch rows
# f32: the repo's forward tolerance; bf16: one bf16 rounding flip (~4e-3
# relative) at the kernels' rounding points, with margin
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (count, head): empty ring, partly filled, full with a wrapped head
MEM_STATES = [(0, 0), (16, 16), (M, 8)]


def _pair(a, dtype):
    """The same f32 numbers as a JAX array and a torch tensor of ``dtype``."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a).astype(JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("count,head", MEM_STATES)
def test_ring_psi_matches_jax(count, head):
    psi = jfa.key_trig_basis(M + T, D_MODEL, jnp.float32)
    ref = jfa.ring_psi(psi, T, jnp.int32(count), jnp.int32(head))
    ours = tfa.ring_psi(tfa.key_trig_basis(M + T, D_MODEL, torch.float32),
                        T, count, head)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    window_only = ours[:, M:]
    assert tfa.ring_psi(window_only, T, 0, 0) is window_only  # no memory


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_project_mem_kv_matches_jax(dtype):
    rng = np.random.default_rng(1)
    j_mem, t_mem = _pair(rng.normal(size=(L1, R, B, D_MODEL, T)), dtype)
    wk, wv = (rng.normal(size=(D_MODEL, HEADS, D_HEAD)) * 0.2
              for _ in range(2))
    layer = 1  # interior stream: the layer is indexed, not sliced
    ref_k, ref_v = jfa.project_mem_kv(j_mem, layer, jnp.asarray(wk, jnp.float32),
                                      jnp.asarray(wv, jnp.float32))
    k, v = tfa.project_mem_kv(t_mem, layer, torch.from_numpy(wk).float(),
                              torch.from_numpy(wv).float())
    assert k.shape == (B, R, HEADS, D_HEAD, T) and k.dtype == TDT[dtype]
    for ours, ref in ((k, ref_k), (v, ref_v)):
        np.testing.assert_allclose(_f32(ours), _f32(ref), rtol=TOL[dtype],
                                   atol=TOL[dtype])


@functools.lru_cache(maxsize=None)
def _jax_attention_mem(same_length: bool):
    return jax.jit(functools.partial(
        jfa.attention_mem, layer_idx=1, d_model=D_MODEL,
        scale=1.0 / D_HEAD ** 0.5, same_length=same_length))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("same_length", [False, True])
@pytest.mark.parametrize("count,head", MEM_STATES)
def test_attention_mem_matches_jax(count, head, same_length, dtype):
    rng = np.random.default_rng(count + head)
    q, k_win, v_win = (_pair(rng.normal(size=(B, HEADS, D_HEAD, T)), dtype)
                       for _ in range(3))
    mem = _pair(rng.normal(size=(L1, R, B, D_MODEL, T)), dtype)
    wk, wv = (rng.normal(size=(D_MODEL, HEADS, D_HEAD)) * 0.2
              for _ in range(2))
    r_kernel = rng.normal(size=(D_MODEL, D_MODEL)) * 0.2
    rwb, rrb = (rng.normal(size=(HEADS, D_HEAD)) * 0.1 for _ in range(2))
    reset = np.array([False, True, False])

    jpsi = jfa.ring_psi(jfa.key_trig_basis(M + T, D_MODEL, JDT[dtype]), T,
                        jnp.int32(count), jnp.int32(head))
    ref = _jax_attention_mem(same_length)(
        q[0], mem[0], wk3=jnp.asarray(wk, JDT[dtype]),
        wv3=jnp.asarray(wv, JDT[dtype]), k_win=k_win[0], v_win=v_win[0],
        w_r=jfa.pack_r_kernel(jnp.asarray(r_kernel, JDT[dtype]), HEADS),
        psi=jpsi, r_w_bias=jnp.asarray(rwb, jnp.float32),
        r_r_bias=jnp.asarray(rrb, jnp.float32), mem_count=jnp.int32(count),
        mem_head=jnp.int32(head), reset=jnp.asarray(reset))

    tpsi = tfa.ring_psi(tfa.key_trig_basis(M + T, D_MODEL, TDT[dtype]), T,
                        count, head)
    ours = tfa.attention_mem(
        q[1], mem[1], 1, torch.from_numpy(wk).to(TDT[dtype]),
        torch.from_numpy(wv).to(TDT[dtype]), k_win[1], v_win[1],
        tfa.pack_r_kernel(torch.from_numpy(r_kernel).to(TDT[dtype]), HEADS),
        tpsi, torch.from_numpy(rwb).float(), torch.from_numpy(rrb).float(),
        count, head, torch.from_numpy(reset), d_model=D_MODEL,
        scale=1.0 / D_HEAD ** 0.5, same_length=same_length)
    assert ours.shape == (B, HEADS, D_HEAD, T) and ours.dtype == TDT[dtype]
    np.testing.assert_allclose(_f32(ours), _f32(ref), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_attention_mem_rejects_a_memory_in_another_dtype():
    q = torch.zeros(B, HEADS, D_HEAD, T)
    with pytest.raises(TypeError):
        tfa.attention_mem(q, torch.zeros(L1, R, B, D_MODEL, T,
                                         dtype=torch.bfloat16), 0,
                          None, None, q, q, None, None, None, None, 0, 0,
                          None, d_model=D_MODEL, scale=0.25,
                          same_length=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer,block", [(0, 0), (1, 3), (2, 2)])
def test_ring_write_layer_exact_and_in_place(layer, block, dtype):
    rng = np.random.default_rng(layer * 7 + block)
    j_buf, t_buf = _pair(rng.normal(size=(L1, R, B, D_MODEL, T)), dtype)
    j_rows, t_rows = _pair(rng.normal(size=(B, D_MODEL, T)), dtype)
    ref = jlayout.ring_write_layer(j_buf, j_rows, layer, jnp.int32(block),
                                   layer_axis=0, ring_axis=1)
    before = t_buf.clone()
    out = tlayout.ring_write_layer(t_buf, t_rows, layer, block)
    assert out is t_buf
    np.testing.assert_array_equal(_f32(out), _f32(ref))
    before[layer, block] = t_rows
    assert torch.equal(out, before)  # nothing else moved
    with pytest.raises(ValueError):
        tlayout.ring_write_layer(t_buf, t_rows, L1, 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_token_nll_matches_jax(dtype):
    rng = np.random.default_rng(3)
    vocab = 40
    j_h, t_h = _pair(rng.normal(size=(B, D_MODEL, T)), dtype)
    emb = (rng.normal(size=(vocab, D_MODEL)) * 0.5).astype(np.float32)
    bias = (rng.normal(size=vocab) * 0.1).astype(np.float32)
    targets = rng.integers(0, vocab, size=(B, T)).astype(np.int32)
    targets[0, -3:] = 0  # PAD targets are scored like any other
    ref = jnll(j_h, jnp.asarray(emb), jnp.asarray(bias), jnp.asarray(targets))
    ours = tnll(t_h, torch.from_numpy(emb), torch.from_numpy(bias),
                torch.from_numpy(targets))
    assert ours.shape == (B, T) and ours.dtype == torch.float32
    # the logits are f32 on both sides: the hidden state's dtype only sets
    # the operand's values
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)
