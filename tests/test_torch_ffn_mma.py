"""The arithmetic of the FFN backward's tensor-core products, on the CPU.

``csrc/ffn_block_bwd.cu`` runs the block's four products on ``mma.sync``:
dh1 = W2 df_c (depth D, zero-padded to a whole 32), da = W1 dh1_c (depth
F) and the weight gradients dW1 = sum a_c dh1_c^T, dW2 = sum h1_d df_c^T over
the B x T tokens.  In f32 they are 3xTF32: each operand split as hi =
rna(x), lo = rna(x - hi), and a_lo b_hi, a_hi b_lo, a_hi b_hi summed in f32,
8 depth values a step in the products (``warp_tile``) and 32 tokens a chunk
in the sums (``reduce_outer_copy``).  These tests hold that arithmetic,
emulated with ``fused_attention.round_tf32`` / ``tf32_split_product_plain``,
to what the kernel must keep:

- 3xTF32 stays within the port's f32 tolerance (1e-4 x max|ref|) of an f64
  product at #8's depths, where single-pass TF32 misses it;
- the dW sums over B x T = 32,768 terms, taken per batch row in 32-token
  chunks, rows in order within a group and the groups in index order as
  ``reduce_outer_copy`` takes them, do too;
- the product epilogue's select, rebuilt in torch from the sign-encoded h1
  as the kernel forms it, dh1 = [h1 > 0] acc scale and h1_d = rnd(max(h1, 0)
  scale), gives ``ffn_block_bwd_plain``'s dh1 and dropped h1 bit for bit
  (through db1, dW1 and dW2, the outputs that read them), f32 and bf16.
"""
import numpy as np
import pytest
import torch

from commu_tpu_torch.ops import fused_attention as fa
from commu_tpu_torch.ops import fused_ffn
import torch_cpu_threads  # noqa: F401  (one intra-op thread)

F32_TOL = 1e-4


def _beyond_scaled(ours, ref, tol=F32_TOL):
    """Elements further than tol x max|ref| + tol x |ref| from ref (f64)."""
    err = (ours.double() - ref).abs()
    return int((err > tol * ref.abs().max() + tol * ref.abs()).sum())


def _single_tf32(a, b):
    return fa.round_tf32(a) @ fa.round_tf32(b)


def _three_tf32_in_steps(a, b, step=8, fold=2048):
    """a @ b as ``tile_product_kernel`` takes it: per 8-deep step the small
    terms first, a_lo b_hi, then a_hi b_lo, then a_hi b_hi, lo read
    truncated, the step's sum added to the f32 accumulator; past a depth of
    ``fold`` (kFoldChunks chunks) in two levels, the accumulator added into
    a second sum every ``fold`` depth values and started afresh."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    deep = None
    for k0 in range(0, a.shape[1], step):
        a_s, b_s = a[:, k0:k0 + step], b[k0:k0 + step]
        a_hi, b_hi = fa.round_tf32(a_s), fa.round_tf32(b_s)
        a_lo, b_lo = fa.truncate_tf32(a_s - a_hi), fa.truncate_tf32(b_s - b_hi)
        acc = acc + (a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi)
        if (k0 + step) % fold == 0 and k0 + step < a.shape[1]:
            deep = acc if deep is None else deep + acc
            acc = torch.zeros_like(acc)
    return acc if deep is None else deep + acc


@pytest.mark.parametrize("name,rows,depth,pad,relu", [
    ("dh1 = W2 df_c over D", 64, 500, 512, False),
    ("da = W1 dh1_c over F", 64, 1000, 1024, True),
    ("da = W1 dh1_c over F at units 1536 (two levels)", 64, 6144, 6144,
     True)])
def test_three_tf32_passes_hold_the_tolerance_at_the_product_depths(
        name, rows, depth, pad, relu):
    """A weight block of std 0.05 times a 128-token activation tile, the
    depth zero-padded to a whole 32 as the kernel stages it; dh1_c is zero
    where the ReLU or mask H dropped it."""
    rng = np.random.RandomState(depth)
    w = (rng.randn(rows, depth) * 0.05).astype(np.float32)
    x = rng.randn(depth, 128).astype(np.float32)
    if relu:
        x *= rng.rand(depth, 128) > 0.55
    w_p = torch.from_numpy(np.pad(w, ((0, 0), (0, pad - depth))))
    x_p = torch.from_numpy(np.pad(x, ((0, pad - depth), (0, 0))))
    ref = torch.from_numpy(w).double() @ torch.from_numpy(x).double()
    assert _beyond_scaled(_three_tf32_in_steps(w_p, x_p), ref) == 0, name
    assert _beyond_scaled(_single_tf32(w_p, x_p), ref) > 0, name


@pytest.mark.parametrize("name,relu_b", [("dW1 = sum a_c dh1_c^T", True),
                                         ("dW2 = sum h1_d df_c^T", False)])
def test_three_tf32_passes_hold_the_tolerance_over_the_dw_sums(name, relu_b):
    """Depth B x T = 256 x 128 tokens, as the copy form of the sums takes
    it: each batch row in 32-token chunks accumulated in f32, the rows of a
    group in order, then the groups in index order (split_rows at the 4 x 8
    tiles of D = 500 x F = 1000: 16 groups of 16 rows).  Eight output rows
    and columns keep it small."""
    rng = np.random.RandomState(11 if relu_b else 12)
    rows, t_len, chunk, per_group = 256, 128, 32, 16
    a = rng.randn(rows, 8, t_len).astype(np.float32)
    b = rng.randn(rows, 8, t_len).astype(np.float32)
    if relu_b:  # dh1_c: the ReLU and mask H leave about 45% of it
        b *= rng.rand(rows, 8, t_len) > 0.55
    else:       # h1_d: post-ReLU, non-negative
        a = np.abs(a) * (rng.rand(rows, 8, t_len) > 0.55)
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    ref = torch.einsum("bmt,bnt->mn", a.double(), b.double())
    groups = []
    for g0 in range(0, rows, per_group):
        acc = torch.zeros(8, 8)
        for bb in range(g0, g0 + per_group):
            for t0 in range(0, t_len, chunk):
                acc = acc + fa.tf32_split_product_plain(
                    a[bb, :, t0:t0 + chunk], b[bb, :, t0:t0 + chunk].t(),
                    raw_lo=True)
        groups.append(acc)
    ours = torch.zeros(8, 8)
    for part in groups:
        ours = ours + part
    assert _beyond_scaled(ours, ref) == 0, name
    single = sum(_single_tf32(a[bb], b[bb].t()) for bb in range(rows))
    assert _beyond_scaled(single, ref) > 0, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,bits", [(0.0, 16), (0.1, 16), (0.1, 8)])
def test_epilogue_select_equals_the_plain_twins_dh1_and_dropped_h1(dtype, p,
                                                                   bits):
    """The kernel's epilogue reads the sign-encoded h1 (+h kept, -h dropped
    by mask H) and forms dh1 = [h1 > 0] acc scale and h1_d = rnd(max(h1, 0)
    scale) with the f32 keep-scale; rebuilt so in torch on acc = W2 df_c,
    they give the twin's db1 = sum dh1, dW1 = sum a_c dh1_c^T and dW2 = sum
    h1_d df_c^T bit for bit."""
    rng = np.random.RandomState(int(p * 10) + bits)
    b, d, f, t = 2, 12, 20, 9
    cdt = dtype

    def arr(*shape, std=1.0):
        return torch.from_numpy((rng.randn(*shape) * std).astype(np.float32))

    w1, w2 = arr(d, f, std=0.3).to(cdt), arr(f, d, std=0.3).to(cdt)
    g1, be1, g2, be2 = (1.0 + arr(d, std=0.1), arr(d, std=0.1),
                        1.0 + arr(d, std=0.1), arr(d, std=0.1))
    drop = dict(seed=977, dropout_p=p, bits=bits)
    fwd = (arr(b, d, t).to(cdt), arr(b, d, t).to(cdt), w1, arr(f, std=0.1),
           w2, arr(d, std=0.1), g1, be1, g2, be2)
    _, norm1, norm2, h1, stats = fused_ffn.ffn_block_fwd_plain(
        *fwd, save=True, **drop)
    if p:
        assert bool((h1.float() < 0).any())  # mask H is in h1's sign
    dy = arr(b, d, t).to(cdt)
    plain = fused_ffn.ffn_block_bwd_plain(w1, w2, g1, be1, g2, norm1, norm2,
                                          h1, stats, dy, **drop)

    # the kernel's operands: df_c from the LN2 backward under mask F, a_c
    dz2 = fused_ffn._ln_bwd(dy.float(), norm2.float(), stats[:, 1], g2)
    if p:
        (keep_f,), scale = fused_ffn._masks(977, p, bits, b, d, f, t, "cpu",
                                            (fused_ffn.SALT_F,))
        df = torch.where(keep_f, dz2 * scale, 0.0)
    else:
        df, scale = dz2, torch.tensor(1.0)
    df_c = df.to(cdt).float()
    a_c = (norm1.float() * g1[:, None] + be1[:, None]).to(cdt).float()
    acc = torch.einsum("fd,bdt->bft", w2.float(), df_c)
    # the epilogue, element by element as the kernel forms it
    h = h1.float()
    dh1 = torch.where(h > 0.0, acc * scale, 0.0)
    dh1_c = dh1.to(cdt).float()
    h1_d = (torch.clamp(h, min=0.0) * scale).to(cdt).float()

    assert torch.equal(dh1.sum(dim=(0, 2)), plain[3])
    assert torch.equal(torch.einsum("bdt,bft->df", a_c, dh1_c), plain[2])
    assert torch.equal(torch.einsum("bft,bdt->fd", h1_d, df_c), plain[4])
