"""The arithmetic of the two fused probes' tensor-core forms, on the CPU.

``csrc/rel_attention_proj_fwd.cu`` (#6) projects a head's memory slabs on
``mma_tile.cuh``'s 128 x 128 tile from a head-major, zero-padded copy of
that head's Wk and Wv columns (wpad [H][Dp][128]: row d holds Wk[d, h dh ..]
then Wv[d, h dh ..], zeros after them and past D); ``csrc/ffn_block_fwd.cu``
and ``ffn_block_bwd.cu`` run the fuse_o form (#9) as the plain form's passes
with o = Wo^T vec in front (an f32 [B][D][T] o, never rounded before mask
O), and dvec = Wo do_c and dWo = sum vec do_c^T beside the backward's
products, do_c rounded to the compute dtype once.  These tests rebuild that
arithmetic in torch and hold it to what the kernels must keep:

- the weight copy, built with the kernel's flat index math, holds head h's
  columns where the tile reads them, at dh 16, 50 and 64, H = 2-10 and
  ragged D;
- the projection through the copy in 3xTF32, 8 depth rows a step as
  ``warp_tile`` takes them, meets the f32 tolerance (1e-4 x max|ref|)
  against f64 where single-pass TF32 misses it;
- the fused-o forward as the passes run it equals ``ffn_block_fwd_plain``
  with ``wo`` and ``jax.vjp``'s forward of the JAX op (f32: rtol 1e-4,
  atol 1e-5 x max|ref|; bf16: 2e-2), and rounding o to bf16 first changes
  its bits;
- dvec and dWo from do_c, rounded once, equal the twin's and the JAX op's at
  the same tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commu_tpu.ops.fused_ffn import ffn_block_fused_o as jffn_o
from commu_tpu_torch.ops import fused_attention as fa
from commu_tpu_torch.ops import fused_ffn

from test_torch_ffn_mma import (F32_TOL, _beyond_scaled, _single_tf32,
                                _three_tf32_in_steps)
from test_torch_train_ops import TDT, WSTD, _close, _jx

TILE_ROWS = 128  # kBM: rows of the projection tile, k dims | v dims | zeros
DEPTH = {torch.float32: 16, torch.bfloat16: 32}  # kDepth: a staged chunk
SEED = 2 ** 31 - 7 - 8192  # batch rows 1 and 2 wrap the int32 row-seed sum


def _round_up(x, m):
    return -(-x // m) * m


def _proj_weight_copy(wk, wv, heads, dh, depth_pad):
    """proj_weights_kernel's wpad [H][Dp][128], element by element from its
    flat index: c = idx % 128, d = idx / 128 % Dp, h = idx / 128 / Dp."""
    d_model = wk.shape[0]
    dp = _round_up(d_model, depth_pad)
    idx = torch.arange(heads * dp * TILE_ROWS)
    c = idx % TILE_ROWS
    row = idx // TILE_ROWS
    d, h = row % dp, row // dp
    live = (d < d_model) & (c < 2 * dh)
    col = h * dh + torch.where(c < dh, c, c - dh)
    flat_at = (torch.where(live, d, 0) * heads * dh
               + torch.where(live, col, 0))
    picked = torch.where(c < dh, wk.reshape(-1)[flat_at],
                         wv.reshape(-1)[flat_at])
    return torch.where(live, picked, torch.zeros((), dtype=wk.dtype)) \
        .reshape(heads, dp, TILE_ROWS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,dh,d_model", [
    (2, 16, 37), (3, 50, 150), (5, 16, 83), (4, 64, 256), (7, 64, 449),
    (10, 50, 500)])
def test_head_major_weight_copy_holds_each_heads_columns(dtype, heads, dh,
                                                         d_model):
    """Rows d < D of head h's slice hold Wk[:, h] in columns 0 .. dh - 1 and
    Wv[:, h] in dh .. 2 dh - 1; every other element is zero, including the
    depth padding to a whole chunk (project_mem_kv.cu's Dp)."""
    rng = np.random.RandomState(heads * dh + d_model)
    wk, wv = (torch.from_numpy(rng.randn(d_model, heads * dh)
                               .astype(np.float32)).to(dtype)
              for _ in range(2))
    wpad = _proj_weight_copy(wk, wv, heads, dh, DEPTH[dtype])
    dp = wpad.shape[1]
    assert dp % DEPTH[dtype] == 0 and dp - d_model < DEPTH[dtype]
    for h in range(heads):
        cols = slice(h * dh, (h + 1) * dh)
        assert torch.equal(wpad[h, :d_model, :dh], wk[:, cols])
        assert torch.equal(wpad[h, :d_model, dh:2 * dh], wv[:, cols])
        assert not wpad[h, :, 2 * dh:].any()
        assert not wpad[h, d_model:].any()


@pytest.mark.parametrize("heads,dh,d_model", [(10, 50, 500), (4, 64, 256)])
def test_projection_through_the_copy_meets_the_f32_tolerance(heads, dh,
                                                             d_model):
    """One slab X_r [D, Tb = 128] of weights of std 0.05 (the model's
    projection slices) through head h's tile, 3xTF32 in 8-deep steps over
    the padded depth: rows o < dh are k_mem[h], dh <= o < 2 dh v_mem[h],
    both within F32_TOL of the f64 product; one TF32 pass is not."""
    rng = np.random.RandomState(dh)
    wk, wv = (torch.from_numpy((rng.randn(d_model, heads * dh) * 0.05)
                               .astype(np.float32)) for _ in range(2))
    x = torch.from_numpy(rng.randn(d_model, 128).astype(np.float32))
    wpad = _proj_weight_copy(wk, wv, heads, dh, DEPTH[torch.float32])
    x_p = torch.nn.functional.pad(x, (0, 0, 0, wpad.shape[1] - d_model))
    for h in (0, heads - 1):
        a = wpad[h].t().contiguous()  # [128 rows][Dp depth]
        tile = _three_tf32_in_steps(a, x_p)
        cols = slice(h * dh, (h + 1) * dh)
        for rows, w in ((slice(0, dh), wk), (slice(dh, 2 * dh), wv)):
            ref = w[:, cols].double().t() @ x.double()
            assert _beyond_scaled(tile[rows], ref) == 0
            assert _beyond_scaled(_single_tf32(a[rows], x_p), ref) > 0
        assert not tile[2 * dh:].any()  # the zero rows stay zero


def _ffn_case(dtype, b, d, f, t, hd, seed):
    rng = np.random.default_rng(seed)
    w = WSTD[dtype]
    arrays = [rng.normal(size=(b, d, t)), rng.normal(size=(b, hd, t)),
              rng.normal(size=(hd, d)) * w, rng.normal(size=(d, f)) * w,
              rng.normal(size=f) * 0.1, rng.normal(size=(f, d)) * w,
              rng.normal(size=d) * 0.1, 1.0 + rng.normal(size=d) * 0.1,
              rng.normal(size=d) * 0.1, 1.0 + rng.normal(size=d) * 0.1,
              rng.normal(size=d) * 0.1]
    dts = [dtype] * 4 + ["float32", dtype] + ["float32"] * 5
    torch_args = [torch.from_numpy(np.asarray(a, np.float32)).to(TDT[x])
                  for a, x in zip(arrays, dts)]
    jax_args = tuple(_jx(a, x) for a, x in zip(arrays, dts))
    return torch_args, jax_args, rng.normal(size=(b, d, t))


def _tile_product(a, x, dtype):
    """out[b] = a x[b] as tile_product_kernel sums it: 3xTF32 in 8-deep
    steps over the zero-padded depth in f32; bf16 operands multiply exactly
    in f32 and sum in f32."""
    if dtype == torch.bfloat16:
        return torch.einsum("mk,bkt->bmt", a.float(), x.float())
    depth = _round_up(a.shape[1], 32)
    a_p = torch.nn.functional.pad(a.float(), (0, depth - a.shape[1]))
    x_p = torch.nn.functional.pad(x.float(), (0, 0, 0, depth - x.shape[1]))
    return torch.stack([_three_tf32_in_steps(a_p, xb) for xb in x_p])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("b,d,f,t,hd", [(3, 32, 48, 8, 24),
                                        (2, 40, 56, 13, 36)])
def test_fused_o_forward_as_the_passes_run_it(dtype, p, b, d, f, t, hd):
    """o = Wo^T vec as the tile sums it, kept f32 into the plain form's
    passes (``ffn_block_fwd_plain`` reads an f32 o as it is), against the
    twin's fuse_o form and the JAX op; in bf16 the same o rounded first, as
    the unfused path rounds it, changes y's bits."""
    cdt = TDT[dtype]
    (x, vec, wo, *rest), jax_args, _ = _ffn_case(dtype, b, d, f, t, hd, b + t)
    drop = dict(seed=SEED, dropout_p=p)
    o = _tile_product(wo.t(), vec, cdt)
    assert o.dtype == torch.float32
    ours = fused_ffn.ffn_block_fwd_plain(x, o, *rest, **drop)
    twin = fused_ffn.ffn_block_fwd_plain(x, vec, *rest, wo=wo, **drop)
    ref = jffn_o(*jax_args, jnp.int32(SEED), p, True)
    _close(ours, ref, dtype, "y, o in f32")
    _close(twin, ref, dtype, "the twin's y")
    if cdt == torch.bfloat16:
        rounded = fused_ffn.ffn_block_fwd_plain(x, o.to(cdt), *rest, **drop)
        assert not torch.equal(rounded, ours)
    else:
        torch.testing.assert_close(ours, twin, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("b,d,f,t,hd", [(3, 32, 48, 8, 24),
                                        (2, 40, 56, 13, 36)])
def test_dvec_and_dwo_from_do_c_rounded_once(dtype, p, b, d, f, t, hd):
    """do_c is the plain backward's do (dz1 under mask O, rounded to the
    compute dtype once); dvec = rnd(Wo do_c) as the tile sums it and dWo =
    sum vec do_c^T in 32-token chunks per batch row, rows in order, as
    reduce_outer_copy takes it, against the twin's fuse_o outputs and
    ``jax.vjp`` of the JAX op."""
    cdt = TDT[dtype]
    (x, vec, wo, w1, b1, w2, b2, g1, be1, g2, be2), jax_args, dy = \
        _ffn_case(dtype, b, d, f, t, hd, 7 * b + t)
    drop = dict(seed=SEED, dropout_p=p)
    _, norm1, norm2, h1, stats = fused_ffn.ffn_block_fwd_plain(
        x, vec, w1, b1, w2, b2, g1, be1, g2, be2, save=True, wo=wo, **drop)
    dy_t = torch.from_numpy(np.asarray(dy, np.float32)).to(cdt)
    saved = (w1, w2, g1, be1, g2, norm1, norm2, h1, stats, dy_t)
    do_c = fused_ffn.ffn_block_bwd_plain(*saved, **drop)[1]
    assert do_c.dtype == cdt
    dvec = _tile_product(wo, do_c, cdt).to(cdt)
    tp = _round_up(t, 32)
    vec_p = torch.nn.functional.pad(vec.float(), (0, tp - t))
    do_p = torch.nn.functional.pad(do_c.float(), (0, tp - t))
    dwo = torch.zeros(hd, d)
    for bb in range(b):
        for t0 in range(0, tp, 32):
            piece = (vec_p[bb, :, t0:t0 + 32], do_p[bb, :, t0:t0 + 32].t())
            dwo = dwo + (fa.tf32_split_product_plain(*piece)
                         if cdt == torch.float32 else piece[0] @ piece[1])
    twin = fused_ffn.ffn_block_bwd_plain(*saved, **drop, vec=vec, wo=wo)
    torch.testing.assert_close(dvec.float(), twin[1].float(),
                               **({"rtol": 1e-4, "atol": 1e-5}
                                  if cdt == torch.float32 else
                                  {"rtol": 2e-2, "atol": 2e-2}))
    scale = float(twin[-1].abs().max())
    tol = 1e-4 if cdt == torch.float32 else 2e-2
    torch.testing.assert_close(dwo, twin[-1], rtol=tol, atol=tol * scale)

    @jax.jit
    def run(args, cot):
        _, vjp = jax.vjp(lambda *a: jffn_o(*a, jnp.int32(SEED), p, True),
                         *args)
        return vjp(cot)
    ref = run(jax_args, _jx(dy, dtype))
    _close(dvec, ref[1], dtype, "dvec")
    _close(dwo, ref[2], dtype, "dWo")
