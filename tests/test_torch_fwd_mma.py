"""The arithmetic of the two forwards on the tensor cores, on the CPU.

``csrc/rel_attention_fwd_mma.cuh`` (the body of ``rel_attention_mem_fwd``)
and ``csrc/ffn_block_fwd.cu`` run their products on ``mma.sync``: 3xTF32 in
f32 (each operand split as hi = rna(x), lo = rna(x - hi), a_lo b_hi + a_hi
b_lo + a_hi b_hi summed in f32), bf16 with f32 sums in bf16, and the
attention's int8 BD as phi_q psi_q on the int8 tensor cores in 32-deep
steps.  These tests hold that arithmetic, emulated with
``fused_attention.round_tf32`` / ``tf32_split_product_plain``,
``quantize_phi_rows`` and ``_int_matmul``, to what the kernels must keep:

- the 3xTF32 product at the attention forward's depths (qw^T k over the
  head width 50 zero-padded to 56, the float BD over 2F = 512, and P v over
  K = 1152 and 2176 in 64-key tiles with the online rescale) within the
  port's f32 tolerance (1e-4 x max|ref|) of an f64 product, where
  single-pass TF32 misses it;
- the int32 sum of phi_q psi_q, taken in 32-deep m16n8k32 steps in any
  order over the words the kernel reads (``_words_along_depth``), equals
  ``_int_matmul``'s;
- the kernel's online softmax over 64-key tiles, each tile's keys split
  between two warps that merge at the end, P rounded before it is
  normalised, gives ``rel_attention_mem_fwd_plain``'s out and lse to the
  tolerance, with a reset row whose first tiles are all masked and with
  dropout at 8 and 16 bits;
- the FFN forward's epilogues (b1, the ReLU, mask H in the saved h1's sign,
  the dropped h1 rounded to S; b2, mask F and + a in f32) rebuilt from the
  two products give ``ffn_block_fwd_plain``'s outputs bit for bit.
"""
import numpy as np
import pytest
import torch

from commu_tpu_torch.ops import fused_attention as fa
from commu_tpu_torch.ops import fused_ffn

F32_TOL = 1e-4
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _beyond_scaled(ours, ref, tol=F32_TOL):
    """Elements further than tol x max|ref| + tol x |ref| from ref (f64)."""
    err = (ours.double() - ref).abs()
    return int((err > tol * ref.abs().max() + tol * ref.abs()).sum())


def _single_tf32(a, b):
    return fa.round_tf32(a) @ fa.round_tf32(b)


@pytest.mark.parametrize("name,m,depth,n,pad", [
    ("AC = qw^T k over dh", 64, 50, 64, 56),
    ("float BD = phi psi over 2F", 64, 512, 64, 512)])
def test_three_tf32_passes_hold_the_tolerance_at_the_score_depths(
        name, m, depth, n, pad):
    """Each score product at its depth, zero-padded to the MMA width as the
    kernel stages it: 3xTF32 within the tolerance of f64, single-pass TF32
    outside it.  qw and k of std 1; phi of u's size (qr W_r over dh = 50 at
    W_r std 0.05), psi in [-1, 1]."""
    rng = np.random.RandomState(depth + n)
    a = rng.randn(m, depth).astype(np.float32)
    b = rng.randn(depth, n).astype(np.float32)
    if "psi" in name:
        a *= 0.35
        b = np.cos(rng.uniform(0, 6.3, (depth, n))).astype(np.float32)
    a_p = torch.from_numpy(np.pad(a, ((0, 0), (0, pad - depth))))
    b_p = torch.from_numpy(np.pad(b, ((0, pad - depth), (0, 0))))
    ref = torch.from_numpy(a).double() @ torch.from_numpy(b).double()
    assert _beyond_scaled(fa.tf32_split_product_plain(a_p, b_p), ref) == 0, name
    assert _beyond_scaled(_single_tf32(a_p, b_p), ref) > 0, name


def _online_pv(s, v, product):
    """O = softmax_rows(s) v taken as the kernel takes it: 64-key tiles, a
    running row maximum and sum, O rescaled as the maximum grows, each
    tile's P v by ``product``, one division at the end."""
    rows, k_len = s.shape
    m_run = torch.full((rows, 1), -torch.finfo(torch.float32).max)
    l_run = torch.zeros(rows, 1)
    o = torch.zeros(rows, v.shape[1])
    for k0 in range(0, k_len, 64):
        tile = s[:, k0:k0 + 64]
        m_new = torch.maximum(m_run, tile.amax(dim=1, keepdim=True))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(tile - m_new)
        l_run = l_run * alpha + p.sum(dim=1, keepdim=True)
        o = o * alpha + product(p, v[k0:k0 + 64])
        m_run = m_new
    return o / l_run


@pytest.mark.parametrize("k_len", [1152, 2176])
def test_three_tf32_passes_hold_the_tolerance_over_p_v_with_the_rescale(k_len):
    """O = P v over K keys in 64-key tiles with the online rescale: 3xTF32
    within the tolerance of the f64 softmax product, single-pass TF32
    outside it.  Scores of std 3, so a few keys carry each row."""
    rng = np.random.RandomState(k_len)
    s = torch.from_numpy((rng.randn(64, k_len) * 3.0).astype(np.float32))
    v = torch.from_numpy(rng.randn(k_len, 50).astype(np.float32))
    ref = torch.softmax(s.double(), dim=1) @ v.double()
    ours = _online_pv(s, v, fa.tf32_split_product_plain)
    assert _beyond_scaled(ours, ref) == 0
    assert _beyond_scaled(_online_pv(s, v, _single_tf32), ref) > 0


@pytest.mark.parametrize("k_len,seed", [(1152, 0), (2176, 1), (99, 2)])
def test_int8_bd_in_32_deep_steps_in_any_order_equals_the_int_matmul(
        k_len, seed):
    """phi_q psi_q as mma.sync m16n8k32 takes it: psi_q as the kernel's
    words of four depth rows (``_words_along_depth``), 32 depth rows (8
    word rows) a step, the steps summed in int32 in a shuffled order; equal
    to ``_int_matmul`` on every element, and so is BD after its scale."""
    rng = np.random.RandomState(seed)
    f2 = 512
    phi = torch.from_numpy((rng.randn(16, f2) * 0.3).astype(np.float32))
    psi = torch.from_numpy(np.cos(rng.uniform(0, 6.3, (f2, k_len)))
                           .astype(np.float32) / 0.9)  # clips at 127
    psi_q = fa.quantize_psi_int8(psi)
    phi_q, amax = fa.quantize_phi_rows(phi)
    want = fa._int_matmul(phi_q, psi_q)
    words = fa._words_along_depth(psi_q)  # [2F / 4, K, 4]
    b_depth = words.permute(0, 2, 1).reshape(f2, k_len).to(torch.int32)
    a_depth = phi_q.to(torch.int32)
    steps = list(range(0, f2, 32))
    rng.shuffle(steps)
    acc = torch.zeros(16, k_len, dtype=torch.int32)
    for d0 in steps:
        acc += a_depth[:, d0:d0 + 32] @ b_depth[d0:d0 + 32]
    back = amax * (1.0 / (127.0 * 127.0))
    assert torch.equal(acc.float(), want)
    assert torch.equal(acc.float() * back, want * back)


def _kernel_softmax(s, keep, scale, dtype):
    """out-side of the kernel from the masked scores s [B, H, T, K] f32:
    per 64-key tile, keys 0-31 to one warp and 32-63 to another, each with
    its own running maximum, sum of the UNDROPPED exponentials and output
    accumulator over P = rnd(dropped exp(s - m_running) x scale); the two
    merged at the end.  Returns (P-weights as a function of v, lse)."""
    k_len = s.shape[-1]
    halves = []
    for first in (0, 32):
        idx = torch.cat([torch.arange(k0 + first, min(k0 + first + 32, k_len))
                         for k0 in range(0, k_len, 64)])
        m_run = torch.full(s.shape[:-1] + (1,),
                           -torch.finfo(torch.float32).max)
        l_run = torch.zeros(s.shape[:-1] + (1,))
        weights = torch.zeros_like(s)
        for k0 in range(0, k_len, 64):
            cols = torch.arange(k0 + first, min(k0 + first + 32, k_len))
            if cols.numel() == 0:
                continue
            tile = s[..., cols]
            m_new = torch.maximum(m_run, tile.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(tile - m_new)
            l_run = l_run * alpha + p.sum(dim=-1, keepdim=True)
            pd = torch.where(keep[..., cols], p * scale, 0.0) \
                if keep is not None else p
            weights = weights * alpha
            weights[..., cols] = pd.to(dtype).float()
            m_run = m_new
        halves.append((m_run, l_run, weights, idx))
    (m1, l1, w1, _), (m2, l2, w2, _) = halves
    m = torch.maximum(m1, m2)
    a1, a2 = torch.exp(m1 - m), torch.exp(m2 - m)
    l = l1 * a1 + l2 * a2
    return (w1 * a1 + w2 * a2) / l, (m + torch.log(l))[..., 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,bits", [(0.0, 16), (0.1, 16), (0.1, 8)])
def test_online_softmax_over_key_tiles_gives_the_plain_twins_out_and_lse(
        dtype, p, bits):
    """The kernel's softmax, emulated in torch on the twin's own masked
    scores, against ``rel_attention_mem_fwd_plain``: a ring of 4 slabs of
    32 (M = 128, K = 168: a ragged last tile), batch row 1 reset, so its
    first two tiles are all masked (NEG_INF from the bf16 table)."""
    rng = np.random.RandomState(int(p * 10) + bits)
    b, h, dh, t, r_blocks, t_blk, d_model = 2, 2, 32, 40, 4, 32, 64
    m_cap = r_blocks * t_blk
    scale = 1.0 / dh ** 0.5

    def arr(*shape, std=1.0):
        return torch.from_numpy((rng.randn(*shape) * std).astype(np.float32))

    q, k_win, v_win = (arr(b, h, dh, t).to(dtype) for _ in range(3))
    k_mem, v_mem = (arr(b, r_blocks, h, dh, t_blk).to(dtype)
                    for _ in range(2))
    w_r = fa.pack_r_kernel(arr(d_model, d_model, std=0.1), h).to(dtype)
    rwbs, rrbs = fa._scaled_biases(arr(h, dh, std=0.1), arr(h, dh, std=0.1),
                                   scale, dtype)
    psi = fa.ring_psi(fa.key_trig_basis(m_cap + t, d_model, dtype), t, 100,
                      70)
    mask = fa.build_mask_bias(t, m_cap, 100, 70, True)
    reset = torch.tensor([0, 1], dtype=torch.int32)
    args = (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r,
            fa.query_trig_table(t, m_cap, d_model, dtype), psi, mask, reset,
            scale)
    drop = dict(seed=4242, dropout_p=p, bits=bits)
    out, s_res, lse = fa.rel_attention_mem_fwd_plain(*args, save=True, **drop)
    assert bool((s_res[1, :, :, :128] < -1e30).all())  # tiles 0, 1 masked
    keep = None
    scale_k = 1.0
    if p:
        keep, scale_k = fa._attention_keep(4242, p, bits, b, h, t,
                                           m_cap + t, "cpu")
    weights, lse_k = _kernel_softmax(s_res, keep, scale_k, dtype)
    v = fa._ring_keys(v_mem, v_win).float()
    out_k = torch.einsum("bhdj,bhij->bhdi", v, weights).to(dtype)
    tol = TOL[dtype]
    torch.testing.assert_close(out_k.float(), out.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse_k, lse, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,bits", [(0.0, 16), (0.1, 16), (0.1, 8)])
def test_ffn_forward_epilogues_rebuilt_from_the_products_equal_the_twin(
        dtype, p, bits):
    """The two product epilogues of ``ffn_block_fwd.cu``, element by element
    as the kernel forms them from acc = W1^T a_c and acc = W2^T h1_d: h1 =
    relu(acc + b1); the dropped h1 rnd(kept ? h1 scale : 0) and the saved
    rnd(kept ? h1 : -h1); z2 = a + mask_F(acc + b2) with a in f32; y and
    norm2 from z2.  Equal to ``ffn_block_fwd_plain``'s outputs bit for bit
    (a, the LN1 output, taken as the twin forms it)."""
    rng = np.random.RandomState(int(p * 10) + bits)
    b, d, f, t = 2, 12, 20, 9

    def arr(*shape, std=1.0):
        return torch.from_numpy((rng.randn(*shape) * std).astype(np.float32))

    w1, w2 = arr(d, f, std=0.3).to(dtype), arr(f, d, std=0.3).to(dtype)
    b1, b2 = arr(f, std=0.1), arr(d, std=0.1)
    g1, be1, g2, be2 = (1.0 + arr(d, std=0.1), arr(d, std=0.1),
                        1.0 + arr(d, std=0.1), arr(d, std=0.1))
    x, o = arr(b, d, t).to(dtype), arr(b, d, t).to(dtype)
    drop = dict(seed=977, dropout_p=p, bits=bits)
    y, norm1, norm2, h1, stats = fused_ffn.ffn_block_fwd_plain(
        x, o, w1, b1, w2, b2, g1, be1, g2, be2, save=True, **drop)

    o_f = o.float()
    scale = torch.tensor(1.0)
    if p:
        (keep_o, keep_h, keep_f), scale = fused_ffn._masks(
            977, p, bits, b, d, f, t, "cpu",
            (fused_ffn.SALT_O, fused_ffn.SALT_H, fused_ffn.SALT_F))
        o_f = torch.where(keep_o, o_f * scale, 0.0)
    n1, rstd1 = fused_ffn._normalize(x.float() + o_f)
    a = n1 * g1[:, None] + be1[:, None]  # __fadd_rn(__fmul_rn(norm, g1), be1)
    acc1 = torch.einsum("df,bdt->bft", w1.float(), a.to(dtype).float())
    hv = torch.relu(acc1 + b1[:, None])
    if p:
        h1_d = torch.where(keep_h, hv * scale, 0.0).to(dtype)
        saved = torch.where(keep_h, hv, -hv).to(dtype)
    else:
        h1_d = saved = (hv * scale).to(dtype)
    acc2 = torch.einsum("fd,bft->bdt", w2.float(), h1_d.float())
    fv = acc2 + b2[:, None]
    if p:
        fv = torch.where(keep_f, fv * scale, 0.0)
    n2, rstd2 = fused_ffn._normalize(a + fv)
    y_k = n2 * g2[:, None] + be2[:, None]

    assert torch.equal(saved, h1)
    assert torch.equal(n1.to(dtype), norm1)
    assert torch.equal(n2.to(dtype), norm2)
    assert torch.equal(y_k.to(dtype), y)
    assert torch.equal(torch.stack([rstd1, rstd2], dim=1), stats)
    if p:
        assert bool((h1.float() < 0).any())  # mask H is in h1's sign


def _window_operands(rng, dtype, b, h, dh, t, d_model):
    def arr(*shape, std=1.0):
        return torch.from_numpy((rng.randn(*shape) * std).astype(np.float32))

    scale = 1.0 / dh ** 0.5
    q, k, v = (arr(b, h, dh, t).to(dtype) for _ in range(3))
    w_r = fa.pack_r_kernel(arr(d_model, d_model, std=0.1), h).to(dtype)
    rwbs, rrbs = fa._scaled_biases(arr(h, dh, std=0.1), arr(h, dh, std=0.1),
                                   scale, dtype)
    reset = torch.tensor([0, 1] * (b // 2) + [0] * (b % 2), dtype=torch.int32)
    return q, rwbs, rrbs, k, v, w_r, reset, scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["float", "int8"])
@pytest.mark.parametrize("p,bits", [(0.0, 16), (0.1, 16), (0.1, 8)])
@pytest.mark.parametrize("save", [False, True])
def test_the_window_alone_is_the_memory_forward_with_no_slabs(dtype, form, p,
                                                              bits, save):
    """The ground for running #1 on #2's body with R = 0: the no-memory twin
    equals the memory twin over empty slabs ([B, 0, H, dh, Tb]) with the
    operands ``attention`` builds (trig table and psi at m_cap = 0, which
    ``ring_psi`` leaves as they are, the causal mask), bit for bit, in every
    form, with a reset row."""
    rng = np.random.RandomState(bits + int(10 * p) + 2 * save)
    b, h, dh, t, d_model = 2, 2, 32, 40, 64
    q, rwbs, rrbs, k, v, w_r, reset, scale = _window_operands(
        rng, dtype, b, h, dh, t, d_model)
    trig_a = fa.query_trig_table(t, 0, d_model, dtype)
    psi = fa.key_trig_basis(t, d_model, dtype)
    assert fa.ring_psi(psi, t, 0, 0) is psi
    mask = fa.build_mask_bias(t, 0, 0, 0, False)
    empty = torch.zeros(b, 0, h, dh, t, dtype=dtype)
    drop = dict(seed=2 ** 31 - 7, dropout_p=p, bits=bits)
    if form == "int8":
        drop["psi_q"] = fa.quantize_psi_int8(psi)
    window = fa.rel_attention_fwd_plain(q, rwbs, rrbs, k, v, w_r, trig_a, psi,
                                        mask, reset, scale, save, **drop)
    memory = fa.rel_attention_mem_fwd_plain(q, rwbs, rrbs, empty, k, empty, v,
                                            w_r, trig_a, psi, mask, reset,
                                            scale, save, **drop)
    for x, y in zip(window if save else (window,),
                    memory if save else (memory,)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _warp_skip_softmax(s, mask_rows, skip):
    """The tensor-core body's softmax over 64-key tiles as its warps take
    it: 16-row groups x 32-key halves, each with its own running maximum,
    sum and output weights, merged at the end (no dropout, f32).  With
    ``skip``, a warp's 16 x 32 region of a tile whose mask is all <= -1e30
    takes S = 0 + mask (no products), and where its P is all zeros it adds
    no P v.  ``mask_rows`` [B, T, K] is each batch row's plane.  Returns
    (weights [B, H, T, K] such that out = v weights^T, lse [B, H, T])."""
    b, h, t, k_len = s.shape
    big = -torch.finfo(torch.float32).max
    weights = torch.zeros_like(s)
    lse = torch.zeros(b, h, t)
    for r0 in range(0, t, 16):
        rows = slice(r0, min(r0 + 16, t))
        halves = []
        for first in (0, 32):
            m_run = torch.full((b, h, rows.stop - r0, 1), big)
            l_run = torch.zeros_like(m_run)
            w = torch.zeros(b, h, rows.stop - r0, k_len)
            for k0 in range(0, k_len, 64):
                cols = slice(k0 + first, min(k0 + first + 32, k_len))
                if cols.start >= k_len:
                    continue
                tile = s[:, :, rows, cols].clone()
                dead = (mask_rows[:, rows, cols] <= -1e30).flatten(1).all(1)
                if skip:  # the region's scores are the mask itself
                    tile[dead] = mask_rows[dead][:, None, rows, cols]
                m_new = torch.maximum(m_run, tile.amax(-1, keepdim=True))
                alpha = torch.exp(m_run - m_new)
                p = torch.exp(tile - m_new)
                l_run = l_run * alpha + p.sum(-1, keepdim=True)
                w = w * alpha
                zero = (p == 0).flatten(2).all(2)
                keep_pv = ~zero if skip else torch.ones_like(zero)
                w[..., cols] = torch.where(keep_pv[..., None, None], p,
                                           w[..., cols])
                m_run = m_new
            halves.append((m_run, l_run, w))
        (m1, l1, w1), (m2, l2, w2) = halves
        m = torch.maximum(m1, m2)
        a1, a2 = torch.exp(m1 - m), torch.exp(m2 - m)
        l = l1 * a1 + l2 * a2
        weights[:, :, rows] = (w1 * a1 + w2 * a2) / l
        lse[:, :, rows] = (m + torch.log(l))[..., 0]
    return weights, lse


@pytest.mark.parametrize("form", ["float", "int8"])
def test_skipping_the_masked_tiles_changes_no_bit(form):
    """At K = T = 128 the upper triangle of the causal plane leaves whole
    16 x 32 warp regions masked (the tile of keys 64-127 for rows 0-63).
    Emulated in f32 on the twin's scores: the softmax with those regions
    skipped (S = 0 + mask, no P v where P is all zeros) gives the same
    weights and lse as without the skip, bit for bit, and the twin's out and
    lse within the f32 tolerance; a reset row included.  NEG_INF absorbs any
    |AC + BD| up to 1e6 in f32, so the skipped S is the bits the products
    would give."""
    rng = np.random.RandomState(5)
    b, h, dh, t, d_model = 2, 2, 50, 128, 100
    q, rwbs, rrbs, k, v, w_r, reset, scale = _window_operands(
        rng, torch.float32, b, h, dh, t, d_model)
    psi = fa.key_trig_basis(t, d_model)
    mask = fa.build_mask_bias(t, 0, 0, 0, False)
    drop = {"psi_q": fa.quantize_psi_int8(psi)} if form == "int8" else {}
    out, s_res, lse = fa.rel_attention_fwd_plain(
        q, rwbs, rrbs, k, v, w_r, fa.query_trig_table(t, 0, d_model), psi,
        mask, reset, scale, save=True, **drop)
    mask_rows = mask.float()[reset.long()]
    assert bool((mask_rows[:, :64, 64:] < -1e30).all())
    skipped = _warp_skip_softmax(s_res, mask_rows, True)
    full = _warp_skip_softmax(s_res, mask_rows, False)
    assert torch.equal(skipped[0], full[0]) and torch.equal(skipped[1],
                                                            full[1])
    out_k = torch.einsum("bhdj,bhij->bhdi", v.float(), skipped[0])
    torch.testing.assert_close(out_k, out, rtol=F32_TOL, atol=F32_TOL)
    torch.testing.assert_close(skipped[1], lse, rtol=F32_TOL, atol=F32_TOL)
    neg_inf = torch.tensor(fa.NEG_INF, dtype=torch.float32)
    table = mask.float()[1]  # the reset row's plane, read from bf16
    assert float(table.min()) == float(neg_inf.bfloat16().float())
    for x in torch.cat([torch.linspace(-1e6, 1e6, 4001),
                        s_res[s_res > -1e30].flatten()[:4000]]):
        assert float(table.min() + x) == float(table.min())
