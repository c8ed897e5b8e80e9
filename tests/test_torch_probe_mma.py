"""The arithmetic of the two fused probes' tensor-core forms, on the CPU.

``csrc/rel_attention_proj_fwd.cu`` (#6) projects a head's memory slabs on
``mma_tile.cuh``'s 128 x 128 tile from a head-major, zero-padded copy of
that head's Wk and Wv columns (wpad [H][Dp][Mp]: row d holds Wk[d, h dh ..]
then Wv[d, h dh ..], zeros after them and past D; Mp = 128 in the narrow
form, 2 dh rounded up to whole tiles of 128 in the wide one); ``csrc/ffn_block_fwd.cu``
and ``ffn_block_bwd.cu`` run the fuse_o form (#9) as the plain form's passes
with o = Wo^T vec in front (an f32 [B][D][T] o, never rounded before mask
O), and dvec = Wo do_c and dWo = sum vec do_c^T beside the backward's
products, do_c rounded to the compute dtype once.  These tests rebuild that
arithmetic in torch and hold it to what the kernels must keep:

- the weight copy, built with the kernel's flat index math, holds head h's
  columns where the tile reads them, at dh 16, 50 and 64 (one row tile),
  96, 128 and 256 (two to four), H = 2-10 and ragged D;
- the projection through the copy in 3xTF32, 8 depth rows a step as
  ``warp_tile`` takes them, meets the f32 tolerance (1e-4 x max|ref|)
  against f64 where single-pass TF32 misses it;
- the fused-o forward as the passes run it equals ``ffn_block_fwd_plain``
  with ``wo`` and ``jax.vjp``'s forward of the JAX op (f32: rtol 1e-4,
  atol 1e-5 x max|ref|; bf16: 2e-2), and rounding o to bf16 first changes
  its bits;
- dvec and dWo from do_c, rounded once, equal the twin's and the JAX op's at
  the same tolerances.

``csrc/wgmma_product.cuh`` (#5, and #4's dWk / dWv sums, on wgmma with
TMA) is held here where its arithmetic and index math allow it:

- #5's weight copy (kv_weights_kernel's flat index math) holds [Wk | Wv]
  K-major, rows padded to whole tiles of 128 and the depth to whole
  chunks, f32 as TF32 hi and raw lo planes that add back to each weight;
- the projection through those planes, 3xTF32 in 8-deep steps, is the
  mma.sync tile's arithmetic bit for bit and meets the f32 tolerance;
- both grids' tile decodes cover every output tile once (#5: row tiles
  fastest; the sums: split_rows' groups of at most 8,192 terms);
- the 128-byte swizzle's offsets permute each 8-row group's 16-byte
  chunks, and the sums' A fragment loads hit 32 distinct banks.
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
import torch_cpu_threads  # noqa: F401  (one intra-op thread)

TILE_ROWS = 128  # kBM: rows of a projection tile, k dims | v dims | zeros
DEPTH = {torch.float32: 16, torch.bfloat16: 32}  # kDepth: a staged chunk
SEED = 2 ** 31 - 7 - 8192  # batch rows 1 and 2 wrap the int32 row-seed sum


def _round_up(x, m):
    return -(-x // m) * m


def _proj_weight_copy(wk, wv, heads, dh, depth_pad):
    """The weight copy wpad [H][Dp][Mp] (proj_weights_kernel's at dh <= 64,
    Mp = 128; proj_weights_wide_kernel's past it, Mp = proj_rows(dh), 2 dh
    in whole tiles of 128), element by element from its flat index: c = idx
    % Mp, d = idx / Mp % Dp, h = idx / Mp / Dp."""
    d_model = wk.shape[0]
    dp = _round_up(d_model, depth_pad)
    mp = _round_up(2 * dh, TILE_ROWS)
    idx = torch.arange(heads * dp * mp)
    c = idx % mp
    row = idx // mp
    d, h = row % dp, row // dp
    live = (d < d_model) & (c < 2 * dh)
    col = h * dh + torch.where(c < dh, c, c - dh)
    flat_at = (torch.where(live, d, 0) * heads * dh
               + torch.where(live, col, 0))
    picked = torch.where(c < dh, wk.reshape(-1)[flat_at],
                         wv.reshape(-1)[flat_at])
    return torch.where(live, picked, torch.zeros((), dtype=wk.dtype)) \
        .reshape(heads, dp, mp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,dh,d_model", [
    (2, 16, 37), (3, 50, 150), (5, 16, 83), (4, 64, 256), (7, 64, 449),
    (10, 50, 500), (3, 96, 40), (2, 128, 37), (2, 256, 21)])
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
    assert wpad.shape[2] % TILE_ROWS == 0
    assert wpad.shape[2] - 2 * dh < TILE_ROWS
    for h in range(heads):
        cols = slice(h * dh, (h + 1) * dh)
        assert torch.equal(wpad[h, :d_model, :dh], wk[:, cols])
        assert torch.equal(wpad[h, :d_model, dh:2 * dh], wv[:, cols])
        assert not wpad[h, :, 2 * dh:].any()
        assert not wpad[h, d_model:].any()


@pytest.mark.parametrize("heads,dh,d_model", [(10, 50, 500), (4, 64, 256),
                                               (2, 128, 96), (2, 256, 64)])
def test_projection_through_the_copy_meets_the_f32_tolerance(heads, dh,
                                                             d_model):
    """One slab X_r [D, Tb = 128] of weights of std 0.05 (the model's
    projection slices) through head h's row tiles, 3xTF32 in 8-deep steps
    over the padded depth: rows o < dh are k_mem[h], dh <= o < 2 dh
    v_mem[h], both within F32_TOL of the f64 product; one TF32 pass is
    not."""
    rng = np.random.RandomState(dh)
    wk, wv = (torch.from_numpy((rng.randn(d_model, heads * dh) * 0.05)
                               .astype(np.float32)) for _ in range(2))
    x = torch.from_numpy(rng.randn(d_model, 128).astype(np.float32))
    wpad = _proj_weight_copy(wk, wv, heads, dh, DEPTH[torch.float32])
    x_p = torch.nn.functional.pad(x, (0, 0, 0, wpad.shape[1] - d_model))
    for h in (0, heads - 1):
        a = wpad[h].t().contiguous()  # [Mp rows][Dp depth]
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
            dwo = dwo + (fa.tf32_split_product_plain(*piece, raw_lo=True)
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


# ---- wgmma_product.cuh: #5's weight copy, the grids, the swizzle ----------

KV_DEPTH = {torch.float32: 32, torch.bfloat16: 64}  # Kv<S>::kBK
MAX_GROUP_TERMS = 8192  # reduce.cuh's kMaxGroupTerms


def _kv_weight_copy(wk, wv, rows):
    """kv_weights_kernel's copy wt [planes][Op][Dp] from its flat index
    (o = idx / Dp, d = idx % Dp): Wcat[d][o] (wk's column o below HD, wv's
    o - HD past it) for o < rows, d < D, else 0; f32 as hi = rna_tf32(w)
    and lo = w - hi, bf16 as it is."""
    d_model, hd = wk.shape
    dp = _round_up(d_model, KV_DEPTH[wk.dtype])
    op = _round_up(rows, TILE_ROWS)
    idx = torch.arange(op * dp)
    o, d = idx // dp, idx % dp
    live = (o < rows) & (d < d_model)
    dd = torch.where(live, d, 0)
    w = torch.where(o < hd, wk[dd, torch.where(o < hd, o, 0)],
                    wv[dd, torch.where((o >= hd) & live, o - hd, 0)])
    w = torch.where(live, w, torch.zeros((), dtype=wk.dtype)).reshape(op, dp)
    if wk.dtype == torch.bfloat16:
        return w[None]
    hi = fa.round_tf32(w)
    return torch.stack([hi, w - hi])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_model,hd", [(37, 32), (150, 150), (500, 500),
                                        (40, 96), (21, 256), (70, 768)])
def test_kv_weight_copy_holds_wcat_k_major(dtype, d_model, hd):
    """Rows o < 2 HD of plane 0 hold [Wk | Wv]^T over d < D; every other
    element is zero (the row padding to whole tiles, the depth padding to
    whole chunks); in f32 plane 0 is TF32 (its low 13 bits clear) and the
    planes add back to each weight exactly."""
    rng = np.random.RandomState(d_model + hd)
    wk, wv = (torch.from_numpy(rng.randn(d_model, hd).astype(np.float32))
              .to(dtype) for _ in range(2))
    wt = _kv_weight_copy(wk, wv, 2 * hd)
    planes, op, dp = wt.shape
    assert planes == (2 if dtype == torch.float32 else 1)
    assert op % TILE_ROWS == 0 and op - 2 * hd < TILE_ROWS
    assert dp % KV_DEPTH[dtype] == 0 and dp - d_model < KV_DEPTH[dtype]
    wcat = torch.cat([wk, wv], dim=1).t()
    whole = wt[0] + wt[1] if planes == 2 else wt[0]
    assert torch.equal(whole[:2 * hd, :d_model], wcat)
    assert not whole[2 * hd:].any() and not whole[:, d_model:].any()
    if planes == 2:
        assert not (wt[0].view(torch.int32) & 0x1FFF).any()
        assert torch.equal(wt[0], fa.round_tf32(whole))


@pytest.mark.parametrize("d_model,hd", [(500, 500), (256, 96), (75, 40)])
def test_kv_product_through_the_planes_is_the_tiles_arithmetic(d_model, hd):
    """One slab X [D, Tb = 128] through the f32 planes as the warpgroup
    product takes them, per 8-deep step x_hi w_lo + x_lo w_hi + x_hi w_hi
    (each lo read truncated to TF32) added to the sums, equals the mma.sync
    tile's arithmetic on the same weights (``_three_tf32_in_steps``) bit
    for bit, and meets the f32 tolerance against f64 where one TF32 pass
    does not."""
    rng = np.random.RandomState(hd)
    wk, wv = (torch.from_numpy((rng.randn(d_model, hd) * 0.05)
                               .astype(np.float32)) for _ in range(2))
    x = torch.from_numpy(rng.randn(d_model, 128).astype(np.float32))
    wt = _kv_weight_copy(wk, wv, 2 * hd)
    dp = wt.shape[2]
    x_p = torch.nn.functional.pad(x, (0, 0, 0, dp - d_model))
    acc = torch.zeros(wt.shape[1], 128)
    for k0 in range(0, dp, 8):
        w_hi, w_lo = wt[0][:, k0:k0 + 8], fa.truncate_tf32(wt[1][:, k0:k0 + 8])
        xs = x_p[k0:k0 + 8]
        x_hi = fa.round_tf32(xs)
        x_lo = fa.truncate_tf32(xs - x_hi)
        acc = acc + (w_lo @ x_hi + w_hi @ x_lo + w_hi @ x_hi)
    wcat = torch.cat([wk, wv], dim=1).t().contiguous()
    a_p = torch.nn.functional.pad(wcat, (0, dp - d_model))
    assert torch.equal(acc[:2 * hd], _three_tf32_in_steps(a_p, x_p))
    assert not acc[2 * hd:].any()
    ref = wcat.double() @ x.double()
    assert _beyond_scaled(acc[:2 * hd], ref) == 0
    assert _beyond_scaled(_single_tf32(wcat, x), ref) > 0


def _split_rows(rows, tiles, length):
    """reduce.cuh's split_rows: about four blocks an SM of 132 over the
    tiles, each group at most kMaxGroupTerms / len rows."""
    want = (4 * 132 + tiles - 1) // tiles
    groups = max(1, min(want, rows))
    rpg = -(-rows // groups)
    cap = MAX_GROUP_TERMS // length if 0 < length < MAX_GROUP_TERMS else 1
    rpg = min(rpg, cap)
    return -(-rows // rpg), rpg


@pytest.mark.parametrize("parts,m,n,rows,length", [
    (2, 500, 500, 256, 1024), (2, 1536, 1536, 256, 1024), (1, 500, 1000, 256, 128),
    (2, 40, 300, 3, 96), (1, 64, 256, 5, 8192), (2, 768, 768, 7, 1024)])
def test_sums_grid_covers_every_tile_once(parts, m, n, rows, length):
    """dw_sums_kernel's decode of a tile index (64 rows fastest, then 256
    columns, then the part, then the group) over split_rows' groups: every
    (part, group, row tile, column tile) once, the groups covering the
    batch rows in order, each at most kMaxGroupTerms terms where a row has
    fewer."""
    m_tiles, n_tiles = -(-m // 64), -(-n // 256)
    groups, rpg = _split_rows(rows, parts * m_tiles * n_tiles, length)
    tiles = groups * parts * m_tiles * n_tiles
    seen = set()
    for tile in range(tiles):
        rest, mt = divmod(tile, m_tiles)
        rest, nt = divmod(rest, n_tiles)
        g, p = divmod(rest, parts)
        seen.add((p, g, mt, nt))
    assert len(seen) == tiles
    spans = [range(g * rpg, min(rows, (g + 1) * rpg)) for g in range(groups)]
    assert [b for span in spans for b in span] == list(range(rows))
    assert all(len(span) > 0 for span in spans)
    if length <= MAX_GROUP_TERMS:
        assert all(len(span) * length <= MAX_GROUP_TERMS for span in spans)


@pytest.mark.parametrize("rows,tb,b,r", [(1000, 128, 256, 8), (3072, 128, 4, 2),
                                         (96, 37, 3, 2), (200, 300, 2, 3)])
def test_kv_grid_covers_every_tile_once(rows, tb, b, r):
    """kv_product_kernel's decode (row tiles of 128 fastest, then token
    tiles of 128, then the output's slab b R + r, read from the ring's slab
    r B + b): every (slab, token tile, row tile) once, and every ring slab
    read."""
    o_tiles, t_tiles = -(-rows // 128), -(-tb // 128)
    seen, ring = set(), set()
    for tile in range(o_tiles * t_tiles * b * r):
        rest, ot = divmod(tile, o_tiles)
        slab, tt = divmod(rest, t_tiles)
        bb, rr = divmod(slab, r)
        seen.add((slab, tt, ot))
        ring.add(rr * b + bb)
    assert len(seen) == o_tiles * t_tiles * b * r
    assert ring == set(range(b * r))


def _sw128(row, byte):
    """wgmma_product.cuh's sw128: TMA's 128-byte swizzle of a tile of
    128-byte rows from a 1,024-byte-aligned base."""
    return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15)


def test_swizzle_permutes_each_groups_chunks_and_spreads_the_a_loads():
    """sw128 maps each 8-row group of 128-byte rows onto itself with its
    16-byte chunks whole; the f32 sums' A fragment loads (rows 16 wi + g,
    depth q, 4 bytes) hit 32 distinct banks; #5's f32 X loads (depth q,
    tokens g) no more than two lanes a bank."""
    offsets = [_sw128(row, byte) for row in range(64) for byte in range(128)]
    assert sorted(offsets) == list(range(64 * 128))
    for row in range(64):
        for chunk in range(8):
            starts = {_sw128(row, 16 * chunk + i) - i for i in range(16)}
            assert len(starts) == 1 and min(starts) // 1024 == row // 8
    for wi, ks, j in [(0, 0, 0), (3, 3, 3), (1, 2, 1)]:
        banks = {(_sw128(16 * wi + g + 8 * (j & 1), 4 * (8 * ks + q + 4 * (j >> 1)))
                  // 4) % 32 for g in range(8) for q in range(4)}
        assert len(banks) == 32
    for ks, j, m in [(0, 0, 0), (3, 3, 48), (2, 1, 16)]:
        lanes = {}
        for g in range(8):
            for q in range(4):
                tok, d = m + g + 8 * (j & 1), 8 * ks + q + 4 * (j >> 1)
                at = tok // 32 * 4096 + _sw128(d, tok % 32 * 4)
                lanes.setdefault(at // 4 % 32, []).append(at)
        assert max(len(v) for v in lanes.values()) <= 2

