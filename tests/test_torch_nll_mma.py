"""The arithmetic of the tied-embedding NLL kernels on the tensor cores, on
the CPU.

``csrc/nll_fwd.cu`` and ``csrc/nll_bwd.cu`` form the logits on the shared
tile (``csrc/mma_tile.cuh``) over the depth D zero-padded to a whole 32: in
f32 by 3xTF32 (each operand split as hi = rna(x), lo = rna(x - hi), a_lo
b_hi + a_hi b_lo + a_hi b_hi summed in f32), in bf16 as h e_hi + h e_lo on
bf16 products (emb split into e_hi = bf16(emb) and e_lo = bf16(emb - e_hi);
a bf16 h is exact).  The forward reduces each 128-row vocabulary tile to a
maximum and a sum of exponentials over its real rows, in two halves of 64
rows (the tile's two warps down) merged per tile, and merges the tiles in
index order.  The backward writes dlogits from the recomputed logits, forms
dh = emb^T dlogits over the vocabulary zero-padded to whole 128s, demb in
``reduce_outer_copy``'s group order and dbias from per-tile row sums.  These
tests hold that arithmetic, emulated with ``fused_attention.round_tf32`` and
``tf32_split_product_plain``, to what the kernels must keep:

- the split products meet 1e-4 (max |err| / (1 + |ref|) against f64) in the
  nll and lse at the eval shape, where one TF32 pass, and bf16 h x TF32
  emb, miss it;
- the per-tile partials merged in index order give ``nll_fwd_plain``'s nll
  and lse and the JAX ``fused_token_nll`` (in interpret mode, as
  ``tests/test_fused_nll.py`` runs it) within 1e-4: V = 729 in six tiles,
  the last with 89 real rows and a target in it, a target out of range, and
  V = 50 in one tile whose second half has no real row;
- the backward's order gives ``nll_bwd_plain``'s dh, demb and dbias within
  the port's tolerances (dh at the dtype's, the f32 sums at 1e-4 x max|ref|).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commu_tpu.ops.fused_nll import fused_token_nll as jax_nll
from commu_tpu_torch.ops import fused_attention as fa
from commu_tpu_torch.ops import fused_nll

F32_TOL = 1e-4
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TILE = 128  # vocabulary rows (and tokens) of the tile
FLT_MAX = float(torch.finfo(torch.float32).max)


def _round_up(x, m):
    return -(-x // m) * m


def _inputs(b, d, t, v, dtype, seed):
    rng = np.random.RandomState(seed)
    hidden = torch.from_numpy(rng.randn(b, d, t).astype(np.float32)).to(dtype)
    emb = torch.from_numpy((rng.randn(v, d) * 0.05).astype(np.float32))
    bias = torch.from_numpy((rng.randn(v) * 0.1).astype(np.float32))
    targets = torch.from_numpy(rng.randint(0, v, (b, t)).astype(np.int32))
    return hidden, emb, bias, targets


def _depth_padded(hidden, emb):
    """h as [Dp, B T] (f32 values) and emb as [V, Dp], zeros past D."""
    b, d, t = hidden.shape
    pad = _round_up(d, 32) - d
    h = hidden.float().permute(1, 0, 2).reshape(d, b * t)
    return (torch.nn.functional.pad(h, (0, 0, 0, pad)),
            torch.nn.functional.pad(emb, (0, pad)))


def _split_emb_product(e, h):
    """h e_hi + h e_lo on bf16 products: e_hi = bf16(e), e_lo = bf16(e -
    e_hi); each product of bf16 values is exact in f32."""
    e_hi = e.bfloat16().float()
    e_lo = (e - e_hi).bfloat16().float()
    return e_hi @ h + e_lo @ h


def _kernel_logits(hidden, emb, bias):
    """[B, T, V] f32 logits as the kernels form them: 3xTF32 for an f32
    hidden state, the split emb for a bf16 one."""
    b, _, t = hidden.shape
    h, e = _depth_padded(hidden, emb)
    if hidden.dtype == torch.float32:
        prod = fa.tf32_split_product_plain(e, h)
    else:
        prod = _split_emb_product(e, h)
    return prod.reshape(-1, b, t).permute(1, 2, 0) + bias


def _rel_err(ours, ref):
    return float(((ours.double() - ref).abs() / (1 + ref.abs())).max())


def _nll_lse_f64(logits, targets):
    logits = logits.double()
    lse = torch.logsumexp(logits, dim=-1)
    return lse - logits.gather(-1, targets.long()[..., None])[..., 0], lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_products_hold_1e4_where_one_pass_misses(dtype):
    """The eval shape (B = 10, T = 128, D = 500, V = 729; emb std 0.05,
    bias std 0.1): the kernel's split products within 1e-4 of f64 in nll
    and lse; one TF32 pass on both operands (f32), or a bf16 h against emb
    rounded to TF32 (bf16), beyond it."""
    hidden, emb, bias, targets = _inputs(10, 500, 128, 729, dtype, 0)
    ref = torch.einsum("vd,bdt->btv", emb.double(), hidden.double()) + bias
    ref_nll, ref_lse = _nll_lse_f64(ref, targets)
    ours = _nll_lse_f64(_kernel_logits(hidden, emb, bias), targets)
    assert _rel_err(ours[0], ref_nll) <= F32_TOL
    assert _rel_err(ours[1], ref_lse) <= F32_TOL
    b, _, t = hidden.shape
    h, e = _depth_padded(hidden, emb)
    one = fa.round_tf32(e) @ (fa.round_tf32(h) if dtype == torch.float32
                              else h)
    one_pass = _nll_lse_f64(one.reshape(-1, b, t).permute(1, 2, 0) + bias,
                            targets)
    assert _rel_err(one_pass[0], ref_nll) > F32_TOL


def _merged_tiles(logits, targets, v):
    """nll, lse from [B, T, V] logits as nll_fwd.cu takes them: each
    128-row tile's two 64-row halves to (maximum, sum of exp) over their
    real rows (an empty half gives (-FLT_MAX, 0)), merged per tile, then the
    tiles in index order; the target's logit where it lies in [0, V)."""
    def half(rows):
        if rows.shape[-1] == 0:
            lead = rows.shape[:-1]
            return torch.full(lead, -FLT_MAX), torch.zeros(lead)
        m = rows.amax(dim=-1)
        return m, torch.exp(rows - m[..., None]).sum(dim=-1)

    parts = []
    for m0 in range(0, _round_up(v, TILE), TILE):
        (m_a, s_a), (m_b, s_b) = (half(logits[..., m0 + h0:min(m0 + h0 + 64, v)])
                                  for h0 in (0, 64))
        m = torch.maximum(m_a, m_b)
        parts.append((m, s_a * torch.exp(m_a - m) + s_b * torch.exp(m_b - m)))
    m = parts[0][0]
    for m_j, _ in parts[1:]:
        m = torch.maximum(m, m_j)
    s = torch.zeros_like(m)
    for m_j, s_j in parts:
        s = s + s_j * torch.exp(m_j - m)
    lse = m + torch.log(s)
    inside = (targets >= 0) & (targets < v)
    picked = logits.gather(-1, targets.clamp(0, v - 1).long()[..., None])
    return lse - torch.where(inside, picked[..., 0], 0.0), lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v", [729, 50])
def test_tile_partials_merged_in_order_give_the_twin_and_jax(dtype, v):
    b, d, t = 3, 500, 40
    hidden, emb, bias, targets = _inputs(b, d, t, v, dtype, v)
    targets[0, 0] = v - 1   # the last tile's last real row
    targets[1, 2] = v + 3   # out of range: no logit
    targets[2, :] = 0       # PAD, scored like any other
    if v > TILE:
        assert v - (_round_up(v, TILE) - TILE) == 89  # the last tile's rows
    nll, lse = _merged_tiles(_kernel_logits(hidden, emb, bias), targets, v)
    ref_nll, ref_lse = fused_nll.nll_fwd_plain(hidden, emb, bias, targets,
                                               save=True)
    torch.testing.assert_close(nll, ref_nll, rtol=F32_TOL, atol=F32_TOL)
    torch.testing.assert_close(lse, ref_lse, rtol=F32_TOL, atol=F32_TOL)
    h_np = hidden.float().numpy()
    j_h = jnp.asarray(h_np, dtype=jnp.bfloat16 if dtype == torch.bfloat16
                      else jnp.float32)
    ref = np.asarray(jax_nll(j_h, jnp.asarray(emb.numpy()),
                             jnp.asarray(bias.numpy()),
                             jnp.asarray(targets.numpy())))
    np.testing.assert_allclose(nll.numpy(), ref, rtol=F32_TOL, atol=F32_TOL)


def _split_rows(rows, tiles):
    """reduce.cuh's split_rows: (groups, rows per group)."""
    want = (4 * 132 + tiles - 1) // tiles
    groups = max(1, min(want, rows))
    rpg = -(-rows // groups)
    return -(-rows // rpg), rpg


def _close_scaled(ours, ref, tol, name):
    ref = ref.float()
    torch.testing.assert_close(ours.float(), ref, rtol=tol,
                               atol=tol * float(ref.abs().max()),
                               msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_order_gives_the_twin(dtype):
    """nll_bwd.cu's order at B = 48, T = 40 (Tp = 64), D = 500, V = 729:
    dlogits from the recomputed split logits and the saved lse into a
    [B, Vp, Tp] workspace (zeros past V and T); dh = emb^T dlogits over the
    depth Vp = 768 in 3xTF32 in both dtypes, rounded to the dtype; demb as
    reduce_outer_copy sums it: per group of batch rows, rows in order, 32
    tokens a chunk in 3xTF32, the groups in index order; dbias from the
    tiles' row sums in index order."""
    b, d, t, v = 48, 500, 40, 729
    hidden, emb, bias, targets = _inputs(b, d, t, v, dtype, 5)
    targets[0, 0] = v - 1
    targets[1, 1] = v + 3
    rng = np.random.RandomState(6)
    dnll = torch.from_numpy(rng.randn(b, t).astype(np.float32))
    dnll[2, t // 2:] = 0.0  # PAD targets get no cotangent
    _, lse = fused_nll.nll_fwd_plain(hidden, emb, bias, targets, save=True)
    tp, vp, dm = _round_up(t, 32), _round_up(v, TILE), _round_up(d, TILE)

    logits = _kernel_logits(hidden, emb, bias)
    inside = ((targets >= 0) & (targets < v))[..., None]
    onehot = torch.nn.functional.one_hot(targets.clamp(0, v - 1).long(), v)
    dl = ((torch.exp(logits - lse[..., None])
           - torch.where(inside, onehot.float(), 0.0)) * dnll[..., None])
    work = torch.zeros(b, vp, tp)
    work[:, :v, :t] = dl.permute(0, 2, 1)

    a_dh = torch.zeros(vp, dm)
    a_dh[:v, :d] = emb
    dh = torch.stack([fa.tf32_split_product_plain(a_dh.t(), work[i])
                      for i in range(b)])[:, :d, :t].to(dtype)

    x = torch.zeros(b, _round_up(d, 32), tp)
    x[:, :d, :t] = hidden.float()
    groups, rpg = _split_rows(b, -(-v // TILE) * -(-d // TILE))
    demb = torch.zeros(v, d)
    for g in range(groups):
        acc = torch.zeros(v, d)
        for i in range(g * rpg, min(b, (g + 1) * rpg)):
            for t0 in range(0, tp, 32):
                acc = acc + fa.tf32_split_product_plain(
                    work[i, :v, t0:t0 + 32], x[i, :d, t0:t0 + 32].t())
        demb = demb + acc
    dbias = torch.zeros(v)
    for i in range(b):
        for t0 in range(0, tp, TILE):
            dbias = dbias + work[i, :v, t0:t0 + TILE].sum(dim=1)

    ref = fused_nll.nll_bwd_plain(hidden, emb, bias, targets, lse, dnll)
    for ours, want, name, tol in ((dh, ref[0], "dh", TOL[dtype]),
                                  (demb, ref[1], "demb", F32_TOL),
                                  (dbias, ref[2], "dbias", F32_TOL)):
        assert ours.shape == want.shape and ours.dtype == want.dtype, name
        _close_scaled(ours, want, tol, name)
