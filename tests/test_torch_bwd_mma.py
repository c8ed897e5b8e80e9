"""The arithmetic of the attention backwards' tensor-core passes, on the CPU.

``csrc/rel_attention_bwd_passes.cuh`` and ``csrc/reduce.cuh`` run every
product of #3 and #4 on ``mma.sync``: 3xTF32 in f32 (each operand split as
hi = rna(x), lo = rna(x - hi), a_lo b_hi + a_hi b_lo + a_hi b_hi summed in
f32), and the int8 dphi form's ds_q psi_q^T on the int8 tensor cores in
32-key steps, with each row's scale taken from the maxima that the key pass
writes per 64-key tile.  These tests hold that arithmetic, emulated with
``fused_attention.round_tf32`` / ``tf32_split_product_plain``,
``quantize_ds_rows`` and ``_int_matmul``, to what the kernels must keep:

- the 3xTF32 product at the backward's contraction depths (the head width
  50 zero-padded to 56, T = 128, K = 1152, 2F = 512, and dWk's batch sum of
  B x M = 262,144 terms, summed per batch row and per group in a fixed
  order as ``reduce_outer_mma`` sums them) within the port's f32 tolerance
  (1e-4 x max|ref|) of an f64 product, where single-pass TF32 misses it;
- the maxima per 64-key tile, reduced, give ``quantize_ds_rows``' row scale
  bit for bit, a row whose maximum sits in the last, ragged tile included;
- the int32 sum of ds_q psi_q^T, taken in 32-key steps in any order over
  the words the kernel reads (``_words_along_keys``), equals
  ``_int_matmul``'s.
"""
import numpy as np
import pytest
import torch

from commu_tpu_torch.ops import fused_attention as fa

F32_TOL = 1e-4


def _beyond_scaled(ours, ref, tol=F32_TOL):
    """Elements further than tol x max|ref| + tol x |ref| from ref (f64)."""
    err = (ours.double() - ref).abs()
    return int((err > tol * ref.abs().max() + tol * ref.abs()).sum())


def _single_tf32(a, b):
    return fa.round_tf32(a) @ fa.round_tf32(b)


@pytest.mark.parametrize("name,m,depth,n,pad", [
    ("dP = dO^T v over dh", 128, 50, 64, 56),
    ("dk = qw ds_c over T", 64, 128, 64, 128),
    ("k ds_c^T over K", 32, 1152, 64, 1152),
    ("ds_c psi^T over K", 32, 1152, 512, 1152),
    ("W_r du^T over 2F", 32, 512, 64, 512),
    ("dW_r = qr du over T", 64, 128, 512, 128)])
def test_three_tf32_passes_hold_the_tolerance_at_the_backward_depths(
        name, m, depth, n, pad):
    """Each product of the two passes at its depth, zero-padded to the MMA
    width as the kernel stages it: 3xTF32 within the tolerance of f64,
    single-pass TF32 outside it.  Operands of std 1 (dO, v, k, the
    queries), a ds of attention size, psi in [-1, 1]."""
    rng = np.random.RandomState(depth + n)
    a = rng.randn(m, depth).astype(np.float32)
    b = rng.randn(depth, n).astype(np.float32)
    if "ds_c" in name and "dk" not in name:
        a *= 1e-3
    if "psi" in name:
        b = np.cos(rng.uniform(0, 6.3, (depth, n))).astype(np.float32)
    a_p = torch.from_numpy(np.pad(a, ((0, 0), (0, pad - depth))))
    b_p = torch.from_numpy(np.pad(b, ((0, pad - depth), (0, 0))))
    ref = torch.from_numpy(a).double() @ torch.from_numpy(b).double()
    assert _beyond_scaled(fa.tf32_split_product_plain(a_p, b_p), ref) == 0, name
    assert _beyond_scaled(_single_tf32(a_p, b_p), ref) > 0, name


def test_three_tf32_passes_hold_the_tolerance_over_the_dwk_batch_sum():
    """dWk = sum_b rnd(dk_mem[b]) ring[b]^T at depth B x M = 256 x 1024,
    taken as the tensor-core reduction takes it: each batch row's product in
    32-deep chunks accumulated in f32, rows in order within a group, then the
    groups in index order.  Eight output rows and columns keep it small."""
    rng = np.random.RandomState(7)
    rows, m_cap, chunk = 256, 1024, 32
    a = torch.from_numpy(rng.randn(rows, 8, m_cap).astype(np.float32))
    b = torch.from_numpy(rng.randn(rows, 8, m_cap).astype(np.float32))
    ref = torch.einsum("bmj,bnj->mn", a.double(), b.double())
    per_group = 29  # split_rows at this tile count: 9 groups of 29 rows
    groups = []
    for g0 in range(0, rows, per_group):
        acc = torch.zeros(8, 8)
        for bb in range(g0, min(rows, g0 + per_group)):
            for j0 in range(0, m_cap, chunk):
                acc = acc + fa.tf32_split_product_plain(
                    a[bb, :, j0:j0 + chunk], b[bb, :, j0:j0 + chunk].t())
        groups.append(acc)
    ours = torch.zeros(8, 8)
    for part in groups:
        ours = ours + part
    assert _beyond_scaled(ours, ref) == 0
    single = sum(_single_tf32(a[bb], b[bb].t()) for bb in range(rows))
    assert _beyond_scaled(single, ref) > 0


def _tile_maxima(ds, tile=64):
    """The key pass's buffer: per (row, 64-key tile) max |ds|, the ragged
    last tile padded with zeros (keys past K have ds = 0)."""
    k_len = ds.shape[-1]
    padded = torch.nn.functional.pad(ds.abs(), (0, -k_len % tile))
    return padded.reshape(*ds.shape[:-1], -1, tile).amax(dim=-1)


@pytest.mark.parametrize("k_len", [1152, 111, 128, 65])
def test_tile_maxima_give_the_whole_row_scale_bit_for_bit(k_len):
    rng = np.random.RandomState(k_len)
    ds = torch.from_numpy((rng.randn(2, 3, 40, k_len) * 1e-3)
                          .astype(np.float32))
    ds[0, 0, 5, -1] = 0.25         # the maximum in the last, ragged tile
    ds[0, 1, 7, k_len // 2] = -0.5  # a negative maximum mid-row
    ds[1, 2, 9] = 0.0               # an empty row: the 1e-30 floor
    ds_q, sc = fa.quantize_ds_rows(ds)
    amax = _tile_maxima(ds).amax(dim=-1, keepdim=True)
    sc_tiles = torch.clamp(amax, min=1e-30) * (1.0 / 127.0)
    assert torch.equal(sc_tiles.view(torch.int32), sc.view(torch.int32))
    assert torch.equal(
        torch.round(ds * torch.reciprocal(sc_tiles)).to(torch.int8), ds_q)
    assert int(ds_q[0, 0, 5, -1]) == 127 and int(ds_q[0, 1, 7, k_len // 2]) \
        == -127


@pytest.mark.parametrize("k_len,seed", [(1152, 0), (111, 1), (128, 2)])
def test_int8_dphi_in_32_key_steps_in_any_order_equals_the_int_matmul(
        k_len, seed):
    """ds_q psi_q^T as the int8 tensor cores take it: psi_q as the kernel's
    words of four keys (``_words_along_keys``, zero-padded), 32 keys (8
    word rows) a step, the steps summed in int32 in a shuffled order; equal
    to ``_int_matmul`` on every element, and so is dphi after its scale."""
    rng = np.random.RandomState(seed)
    f2 = 256
    ds = torch.from_numpy((rng.randn(16, k_len) * 1e-3).astype(np.float32))
    psi = torch.from_numpy(np.cos(rng.uniform(0, 6.3, (f2, k_len)))
                           .astype(np.float32) / 0.9)  # clips at 127
    psi_q = fa.quantize_psi_int8(psi)
    ds_q, sc = fa.quantize_ds_rows(ds)
    want = fa._int_matmul(ds_q, psi_q.t())
    words = fa._words_along_keys(psi_q)  # [ceil(K / 4), 2F, 4]
    kw = words.shape[0]
    b_keys = words.permute(0, 2, 1).reshape(kw * 4, f2).to(torch.int32)
    a_keys = torch.nn.functional.pad(ds_q, (0, kw * 4 - k_len)).to(torch.int32)
    steps = list(range(0, kw * 4, 32))
    rng.shuffle(steps)
    acc = torch.zeros(16, f2, dtype=torch.int32)
    for j0 in steps:
        acc += a_keys[:, j0:j0 + 32] @ b_keys[j0:j0 + 32]
    assert torch.equal(acc.float(), want)
    assert torch.equal(acc.float() * (sc * (1.0 / 127.0)),
                       want * (sc * (1.0 / 127.0)))
