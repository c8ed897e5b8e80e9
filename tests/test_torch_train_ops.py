"""The port's backward ops against ``jax.vjp`` of the JAX package's, on the
CPU.

``embed_bdt``, ``fused_token_nll``, ``ffn_block`` and ``attention_mem``
(with an empty ring, a partly filled one and a full, wrapped one, and a
reset row): inputs and cotangents come from numpy with a fixed seed and go
through both sides.  The JAX side runs its Pallas kernels in interpreter
mode, jitted; the port's wrappers run their plain twins (CPU tensors)
inside its autograd ``Function``s.  Every cotangent is compared, the
in-kernel weight and bias gradients included.  f32: rtol 1e-4 and atol
1e-5 of the largest reference magnitude; bf16 (inputs of std 0.05 where
they are weights): 2e-2 of it, a few bf16 rounding flips.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commu_tpu.ops import fused_attention as jfa
from commu_tpu.ops.embed import embed_bdt as jembed
from commu_tpu.ops.fused_ffn import ffn_block as jffn
from commu_tpu.ops.fused_nll import fused_token_nll as jnll
from commu_tpu_torch.ops import fused_attention as tfa
from commu_tpu_torch.ops.embed import embed_bdt as tembed
from commu_tpu_torch.ops.fused_ffn import ffn_block as tffn
from commu_tpu_torch.ops.fused_nll import fused_token_nll as tnll
import torch_cpu_threads  # noqa: F401  (one intra-op thread)

D_MODEL, HEADS, D_FF = 32, 2, 48
D_HEAD = D_MODEL // HEADS
T, R = 8, 4
M = R * T
L1, B = 3, 3
VOCAB = 729
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 2e-2)}
WSTD = {"float32": 0.2, "bfloat16": 0.05}
MEM_STATES = [(0, 0, False), (16, 16, True), (M, 8, False)]


def _close(ours, ref, dtype, name):
    """``ours`` (torch) against ``ref`` (JAX) at the dtype's tolerance: rtol,
    and atol as a fraction of the largest reference magnitude."""
    rtol, frac = TOL[dtype]
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert tuple(ours.shape) == ref.shape, name
    np.testing.assert_allclose(ours.detach().float().numpy(), ref, rtol=rtol,
                               atol=frac * float(np.abs(ref).max()),
                               err_msg=name)


def _leaf(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        TDT[dtype]).requires_grad_(True)


def _jx(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32)).astype(JDT[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_bdt_backward_matches_jax(dtype):
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(VOCAB, D_MODEL)).astype(np.float32)
    tokens = rng.integers(0, VOCAB, size=(B, T)).astype(np.int32)
    tokens[0, :3] = 0        # PAD inputs count too
    tokens[1, 2:5] = 17      # repeats sum
    g = rng.normal(size=(B, D_MODEL, T))
    scale = D_MODEL ** 0.5

    out, vjp = jax.vjp(lambda e: jembed(e, jnp.asarray(tokens), scale,
                                        JDT[dtype]), jnp.asarray(emb))
    (ref,) = vjp(_jx(g, dtype))
    t_emb = torch.from_numpy(emb).requires_grad_(True)
    ours = tembed(t_emb, torch.from_numpy(tokens), scale, TDT[dtype])
    _close(ours, out, dtype, "forward")
    ours.backward(torch.from_numpy(np.asarray(g, np.float32)).to(TDT[dtype]))
    assert t_emb.grad.dtype == torch.float32
    _close(t_emb.grad, ref, "float32", "d(emb)")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_token_nll_backward_matches_jax(dtype):
    rng = np.random.default_rng(1)
    h = rng.normal(size=(B, D_MODEL, T))
    emb = (rng.normal(size=(VOCAB, D_MODEL)) * 0.2).astype(np.float32)
    bias = (rng.normal(size=VOCAB) * 0.1).astype(np.float32)
    targets = rng.integers(1, VOCAB, size=(B, T)).astype(np.int32)
    targets[2, 5:] = 0
    dnll = rng.normal(size=(B, T)).astype(np.float32)
    dnll[2, 5:] = 0.0        # the loss gives PAD targets no cotangent

    f = jax.jit(lambda *a: jax.vjp(
        lambda hh, e, bb: jnll(hh, e, bb, jnp.asarray(targets)), *a[:3])[1](
            a[3]))
    ref = f(_jx(h, dtype), jnp.asarray(emb), jnp.asarray(bias),
            jnp.asarray(dnll))
    leaves = (_leaf(h, dtype), _leaf(emb, "float32"), _leaf(bias, "float32"))
    tnll(*leaves, torch.from_numpy(targets)).backward(torch.from_numpy(dnll))
    for leaf, r, name in zip(leaves, ref, ("dh", "d(emb)", "d(bias)")):
        _close(leaf.grad, r, dtype if name == "dh" else "float32", name)
    assert leaves[0].grad.dtype == TDT[dtype]


@functools.lru_cache(maxsize=None)
def _jax_ffn_vjp():
    def run(args, dy):
        return jax.vjp(lambda *a: jffn(*a, jnp.int32(0), 0.0, True), *args)[1](dy)
    return jax.jit(run)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_block_backward_matches_jax(dtype):
    rng = np.random.default_rng(2)
    w = WSTD[dtype]
    arrays = [rng.normal(size=(B, D_MODEL, T)), rng.normal(size=(B, D_MODEL, T)),
              rng.normal(size=(D_MODEL, D_FF)) * w, rng.normal(size=D_FF) * 0.1,
              rng.normal(size=(D_FF, D_MODEL)) * w, rng.normal(size=D_MODEL) * 0.1,
              1.0 + rng.normal(size=D_MODEL) * 0.1, rng.normal(size=D_MODEL) * 0.1,
              1.0 + rng.normal(size=D_MODEL) * 0.1, rng.normal(size=D_MODEL) * 0.1]
    dts = [dtype] * 3 + ["float32", dtype] + ["float32"] * 5
    dy = rng.normal(size=(B, D_MODEL, T))
    ref = _jax_ffn_vjp()(tuple(_jx(a, d) for a, d in zip(arrays, dts)),
                         _jx(dy, dtype))
    leaves = [_leaf(a, d) for a, d in zip(arrays, dts)]
    y = tffn(*leaves)
    y.backward(torch.from_numpy(np.asarray(dy, np.float32)).to(TDT[dtype]))
    names = ("dx", "do", "dW1", "db1", "dW2", "db2", "dg1", "dbe1", "dg2",
             "dbe2")
    for leaf, r, d, name in zip(leaves, ref, dts, names):
        assert leaf.grad.dtype == TDT[d], name  # w1/w2 come back rounded
        _close(leaf.grad, r, dtype, name)


@functools.lru_cache(maxsize=None)
def _jax_attention_vjp(same_length: bool):
    def run(args, mem, psi, count, head, reset, g):
        def f(q, wk3, wv3, k_win, v_win, w_r, rwb, rrb):
            return jfa.attention_mem(
                q, mem, 1, wk3, wv3, k_win, v_win, w_r, psi, rwb, rrb, count,
                head, reset, d_model=D_MODEL, scale=1.0 / D_HEAD ** 0.5,
                same_length=same_length, train=True)
        out, vjp = jax.vjp(f, *args)
        return out, vjp(g)
    return jax.jit(run)


def _attention_case(count, head, dtype, seed):
    rng = np.random.default_rng(seed)
    w = WSTD[dtype]
    acts = [rng.normal(size=(B, HEADS, D_HEAD, T)) for _ in range(3)]
    wk, wv = (rng.normal(size=(D_MODEL, HEADS, D_HEAD)) * w for _ in range(2))
    r_kernel = rng.normal(size=(D_MODEL, D_MODEL)) * w
    rwb, rrb = (rng.normal(size=(HEADS, D_HEAD)) * 0.1 for _ in range(2))
    mem = rng.normal(size=(L1, R, B, D_MODEL, T))
    g = rng.normal(size=(B, HEADS, D_HEAD, T))
    return acts, wk, wv, r_kernel, rwb, rrb, mem, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("count,head,same_length", MEM_STATES)
def test_attention_mem_backward_matches_jax(count, head, same_length, dtype):
    (q, k_win, v_win), wk, wv, r_kernel, rwb, rrb, mem, g = _attention_case(
        count, head, dtype, 3 + count)
    reset = np.array([False, True, False])
    jdt = JDT[dtype]
    jpsi = jfa.ring_psi(jfa.key_trig_basis(M + T, D_MODEL, jdt), T,
                        jnp.int32(count), jnp.int32(head))
    jw_r = jfa.pack_r_kernel(_jx(r_kernel, dtype), HEADS)
    args = (_jx(q, dtype), _jx(wk, dtype), _jx(wv, dtype), _jx(k_win, dtype),
            _jx(v_win, dtype), jw_r, _jx(rwb, "float32"), _jx(rrb, "float32"))
    ref_out, ref = _jax_attention_vjp(same_length)(
        args, _jx(mem, dtype), jpsi, jnp.int32(count), jnp.int32(head),
        jnp.asarray(reset), _jx(g, dtype))

    leaves = [_leaf(q, dtype), _leaf(wk, dtype), _leaf(wv, dtype),
              _leaf(k_win, dtype), _leaf(v_win, dtype),
              tfa.pack_r_kernel(_leaf(r_kernel, dtype), HEADS).detach()
              .requires_grad_(True),
              _leaf(rwb, "float32"), _leaf(rrb, "float32")]
    tpsi = tfa.ring_psi(tfa.key_trig_basis(M + T, D_MODEL, TDT[dtype]), T,
                        count, head)
    out = tfa.attention_mem(
        leaves[0], torch.from_numpy(np.asarray(mem, np.float32)).to(TDT[dtype]),
        1, leaves[1], leaves[2], leaves[3], leaves[4], leaves[5], tpsi,
        leaves[6], leaves[7], count, head, torch.from_numpy(reset),
        d_model=D_MODEL, scale=1.0 / D_HEAD ** 0.5, same_length=same_length)
    _close(out, ref_out, dtype, "forward")
    out.backward(torch.from_numpy(np.asarray(g, np.float32)).to(TDT[dtype]))
    names = ("dq", "dWk", "dWv", "dk_win", "dv_win", "dW_r", "d r_w_bias",
             "d r_r_bias")
    for leaf, r, name in zip(leaves, ref, names):
        if count == 0 and name in ("dWk", "dWv"):
            # an empty ring is fully masked: no key of it gets a gradient
            assert float(leaf.grad.abs().max()) == 0.0
            np.testing.assert_array_equal(np.asarray(r, np.float32), 0.0)
            continue
        _close(leaf.grad, r, dtype, name)


def test_attention_mem_saves_no_residual_without_autograd():
    (q, k_win, v_win), wk, wv, r_kernel, rwb, rrb, mem, _ = _attention_case(
        M, 8, "float32", 0)
    args = [torch.from_numpy(np.asarray(a, np.float32)) for a in
            (q, wk, wv, k_win, v_win)]
    out = tfa.attention_mem(
        args[0], torch.from_numpy(np.asarray(mem, np.float32)), 1, args[1],
        args[2], args[3], args[4],
        tfa.pack_r_kernel(torch.from_numpy(r_kernel).float(), HEADS),
        tfa.ring_psi(tfa.key_trig_basis(M + T, D_MODEL, torch.float32), T, M,
                     8),
        torch.from_numpy(rwb).float(), torch.from_numpy(rrb).float(), M, 8,
        None, d_model=D_MODEL, scale=1.0 / D_HEAD ** 0.5, same_length=False)
    assert out.grad_fn is None and not out.requires_grad
    # the no-memory attention likewise: a residual only when autograd asks
    window = (args[3], args[4],
              tfa.pack_r_kernel(torch.zeros(D_MODEL, D_MODEL), HEADS),
              tfa.key_trig_basis(T, D_MODEL, torch.float32),
              torch.zeros(HEADS, D_HEAD), torch.zeros(HEADS, D_HEAD), None)
    call = dict(d_model=D_MODEL, scale=0.25, same_length=False)
    out = tfa.attention(args[0], *window, **call)
    assert out.grad_fn is None and not out.requires_grad
    out = tfa.attention(args[0].clone().requires_grad_(True), *window, **call)
    assert out.grad_fn is not None
    with torch.no_grad():
        out = tfa.attention(args[0].clone().requires_grad_(True), *window,
                            **call)
    assert out.grad_fn is None
