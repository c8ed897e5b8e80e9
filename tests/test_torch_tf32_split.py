"""The 3xTF32 arithmetic of ``csrc/project_mem_kv.cu``'s f32 form, on the CPU.

The kernel rounds each operand to TF32 as ``cvt.rna.tf32.f32`` does, splits
it into hi = rna(x) and lo = rna(x - hi), and sums a_lo b_hi + a_hi b_lo +
a_hi b_hi in f32 on the tensor cores.  ``fused_attention.round_tf32`` and
``tf32_split_product_plain`` emulate that in plain torch; these tests hold
the emulation to the rounding's definition and the arithmetic to the port's
f32 tolerance (1e-4) against an f64 product, at the projection's depth
D = 500, where single-pass TF32 misses it.
"""
import numpy as np
import pytest
import torch

from commu_tpu_torch.ops import fused_attention as fa

F32_TOL = 1e-4


@pytest.mark.parametrize("x,want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),          # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -9),       # a tie, odd below
    (1.0 + 2.0 ** -12, 1.0),                       # below half: down
    (1.0 + 2.0 ** -11 + 2.0 ** -20, 1.0 + 2.0 ** -10),
    (0.0, 0.0), (3.0, 3.0), (2.0 ** -130, 2.0 ** -130)])  # subnormal kept
def test_round_tf32_rounds_as_cvt_rna(x, want):
    got = fa.round_tf32(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want
    assert int(got.view(torch.int32).item()) & 0x1FFF == 0


def test_round_tf32_is_the_nearest_tf32_value():
    x = torch.from_numpy(np.random.RandomState(0).randn(4096)
                         .astype(np.float32) * 37.0)
    r = fa.round_tf32(x).double()
    # the TF32 spacing at |x|: 2^(exponent - 10)
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(x.double())[1] - 11)
    assert bool(((r - x.double()).abs() <= ulp / 2).all())
    assert bool((fa.round_tf32(-x) == -fa.round_tf32(x)).all())


def _operands(seed, d=500, rows=1000, tokens=128):
    rng = np.random.RandomState(seed)
    w_t = torch.from_numpy((rng.randn(rows, d) * 0.05).astype(np.float32))
    x = torch.from_numpy(rng.randn(d, tokens).astype(np.float32))
    return w_t, x


def _beyond(ours, ref, tol):
    err = (ours.double() - ref).abs()
    return int((err > tol + tol * ref.abs()).sum())


@pytest.mark.parametrize("seed", [0, 1])
def test_three_tf32_passes_meet_the_f32_tolerance_where_one_misses(seed):
    """[Wk | Wv]^T X at D = 500, weights of std 0.05: the 3xTF32 sum within
    atol = rtol = 1e-4 of the f64 product everywhere; single-pass TF32 (both
    operands rounded, f32 sums) outside it."""
    w_t, x = _operands(seed)
    ref = w_t.double() @ x.double()
    assert _beyond(fa.tf32_split_product_plain(w_t, x), ref, F32_TOL) == 0
    assert _beyond(fa.round_tf32(w_t) @ fa.round_tf32(x), ref, F32_TOL) > 0


def test_three_tf32_passes_match_the_projection_twin():
    """The emulation applied per slab agrees with ``project_mem_kv_plain``
    (f32 sums) at the f32 tolerance, ragged widths included."""
    rng = np.random.RandomState(3)
    l1, r, b, d, tb, hd = 3, 2, 3, 72, 40, 36
    mem = torch.from_numpy(rng.randn(l1, r, b, d, tb).astype(np.float32))
    wk, wv = (torch.from_numpy((rng.randn(d, hd) * 0.05).astype(np.float32))
              for _ in range(2))
    kp, vp = fa.project_mem_kv_plain(mem, 1, wk, wv)
    w_t = torch.cat([wk, wv], dim=1).t()
    for rr in range(r):
        for bb in range(b):
            out = fa.tf32_split_product_plain(w_t, mem[1, rr, bb])
            torch.testing.assert_close(out[:hd], kp[bb, rr], rtol=F32_TOL,
                                       atol=F32_TOL)
            torch.testing.assert_close(out[hd:], vp[bb, rr], rtol=F32_TOL,
                                       atol=F32_TOL)
