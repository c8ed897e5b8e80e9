"""The port's dropout against the JAX package's, on the CPU, from the same
seeds and with no patched masks.

Off the TPU the JAX kernels draw their masks from a hash of (seed, draw
count, element index) (``commu_tpu/ops/fused_attention.py:140-162``) and
``random_keep`` turns the words into a keep mask; ``ops.prng.keep_mask`` is
the port's copy of that contract, so both sides drop the same elements.
Held here: the mask bit for bit on planes that take each of the three
16-bit branches; ``dropout_bdt`` forward and ``jax.vjp`` (bit for bit); the
forwards of ``ffn_block``, ``attention_mem`` and ``attention``, and the first
two's gradients against ``jax.vjp``, at p = 0.1 and 0.5, with reset rows
and a wrapped ring.  The JAX side runs its Pallas kernels in interpreter
mode, jitted; the port's wrappers run their plain twins (CPU tensors).
f32: rtol 1e-4 and atol 1e-4 of the largest reference magnitude; bf16
(weights of std 0.05): 2e-2 of it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commu_tpu.ops import dropout as jdrop
from commu_tpu.ops import fused_attention as jfa
from commu_tpu.ops import fused_ffn as jffn
from commu_tpu_torch.ops import dropout as tdrop
from commu_tpu_torch.ops import fused_attention as tfa
from commu_tpu_torch.ops import fused_ffn as tffn
from commu_tpu_torch.ops import prng

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}
WSTD = {"float32": 0.2, "bfloat16": 0.05}
# planes by the branch of random_keep they take: columns split (cols / 2 a
# multiple of 128), rows split (even rows), no split (odd rows)
PLANES = {"cols": [(4, 256), (7, 512)], "rows": [(6, 48), (16, 40), (250, 16)],
          "none": [(7, 9), (5, 48), (1, 3)]}
SEEDS = [0, 1, 12345, 2 ** 31 - 2, 2 ** 31 - 1 - 5 * 16384]


def _close(ours, ref, dtype, name):
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


def _tt(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dtype])


@pytest.mark.parametrize("branch", sorted(PLANES))
@pytest.mark.parametrize("p", [0.1, 0.5, 0.999999])
def test_keep_mask_equals_the_jax_hash_bit_for_bit(branch, p):
    mode = {"cols": 0, "rows": 1, "none": 2}[branch]
    for shape in PLANES[branch]:
        assert prng.draw_geometry(*shape)[0] == mode, shape
        for seed in SEEDS:
            # an int32 sum that wraps, as a kernel's seed + b * stride does
            jfa._prng_seed(jnp.int32(seed) + jnp.int32(5 * 16384))
            ref = np.asarray(jfa.random_keep(shape, p))
            ours = prng.keep_mask(seed + 5 * 16384, shape, p).numpy()
            np.testing.assert_array_equal(ours, ref, err_msg=f"{shape} {seed}")
    batch = prng.keep_mask(torch.tensor([[3, 4], [5, 6]]), PLANES[branch][0], p)
    assert batch.shape == (2, 2) + PLANES[branch][0]
    np.testing.assert_array_equal(
        batch[1, 0].numpy(), prng.keep_mask(5, PLANES[branch][0], p).numpy())


def test_threshold_scale_and_realised_rate():
    assert prng.dropout_threshold(0.1) == 6554
    assert prng.dropout_threshold(0.0) == 0
    assert prng.dropout_threshold(1.0) == 0xFFFF
    for p in (0.1, 0.5, 0.25):
        assert prng.effective_dropout_p(p) == jfa.effective_dropout_p(p)
        assert prng.keep_scale_for(p) == jfa.keep_scale_for(p, True)
    assert prng.keep_scale_for(0.1, train=False) == 1.0
    keep = prng.keep_mask(99, (500, 128), 0.1)
    assert abs(float(keep.float().mean()) - (1 - 6554 / 65536)) < 5e-3
    other = prng.keep_mask(100, (500, 128), 0.1)
    assert not torch.equal(keep, other)
    assert prng.kernel_args(2 ** 31 + 5, 0.1)[:2] == (5 - 2 ** 31, 6554)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("shape", [(3, 6, 16), (4, 7, 9), (2, 8, 256)])
def test_dropout_bdt_forward_and_vjp_match_jax(shape, p, dtype):
    rng = np.random.default_rng(0)
    x, g = rng.normal(size=shape), rng.normal(size=shape)
    for seed, salt in ((777, jdrop.SALT_EMB), (2 ** 31 - 3, jdrop.SALT_OUT)):
        y, vjp = jax.vjp(lambda a: jdrop.dropout_bdt(a, jnp.int32(seed), p,
                                                     salt), _jx(x, dtype))
        (gx,) = vjp(_jx(g, dtype))
        leaf = _leaf(x, dtype)
        ours = tdrop.dropout_bdt(leaf, seed, p, salt)
        ours.backward(_tt(g, dtype))
        assert ours.dtype == TDT[dtype] and leaf.grad.dtype == TDT[dtype]
        np.testing.assert_array_equal(
            ours.detach().float().numpy(), np.asarray(y.astype(jnp.float32)))
        np.testing.assert_array_equal(
            leaf.grad.float().numpy(), np.asarray(gx.astype(jnp.float32)))
    assert (tdrop.SALT_EMB, tdrop.SALT_OUT) == (jdrop.SALT_EMB, jdrop.SALT_OUT)
    assert tdrop.dropout_bdt(leaf, 1, 0.0, 5) is leaf


# (B, D, T) by the branch the [D, T] plane takes at 8 bits: rows quartered,
# columns quartered, rows halved, columns halved, the whole plane
BDT_SHAPES_8 = [(3, 8, 16), (2, 8, 512), (3, 6, 16), (2, 7, 256), (4, 7, 9)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", BDT_SHAPES_8)
def test_dropout_bdt_at_8_bits_matches_jax(shape, dtype, monkeypatch):
    """``COMMU_DROPOUT_BITS=8`` on both sides: the same values and
    cotangents bit for bit, at the realised rate 26/256."""
    monkeypatch.setenv("COMMU_DROPOUT_BITS", "8")
    test_dropout_bdt_forward_and_vjp_match_jax(shape, 0.1, dtype)
    x = torch.ones(shape, dtype=TDT[dtype])
    y = tdrop.dropout_bdt(x, 5, 0.1, tdrop.SALT_EMB)
    kept = y[y != 0].float()
    assert torch.equal(kept, torch.full_like(
        kept, float(torch.tensor(1.0 / (1.0 - 26 / 256)).to(TDT[dtype]))))
    # the backward redraws at the forward's width, whatever the variable
    # says by then
    leaf = torch.ones(shape, dtype=TDT[dtype], requires_grad=True)
    out = tdrop.dropout_bdt(leaf, 5, 0.1, tdrop.SALT_EMB)
    monkeypatch.setenv("COMMU_DROPOUT_BITS", "16")
    out.backward(torch.ones_like(out))
    assert torch.equal(leaf.grad, y)
    assert not torch.equal(tdrop.dropout_bdt(x, 5, 0.1, tdrop.SALT_EMB), y)


# (B, D, F, T) at 8 bits: rows quartered in all three planes; columns
# quartered (T = 512); D rows halved, F whole (D = 6, F = 9); none splits
FFN_SHAPES_8 = [(3, 32, 48, 8), (2, 8, 12, 512), (2, 6, 9, 5), (2, 7, 9, 5)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FFN_SHAPES_8)
def test_ffn_block_at_8_bits_matches_jax(shape, dtype, monkeypatch):
    """The block's three masks at ``COMMU_DROPOUT_BITS=8`` on both sides,
    forward and backward, at the tolerances of the 16-bit case."""
    monkeypatch.setenv("COMMU_DROPOUT_BITS", "8")
    test_ffn_block_dropout_forward_and_backward_match_jax(shape, 0.1, dtype)


def _ffn_arrays(rng, b, d, f, t, w):
    return [rng.normal(size=(b, d, t)), rng.normal(size=(b, d, t)),
            rng.normal(size=(d, f)) * w, rng.normal(size=f) * 0.1,
            rng.normal(size=(f, d)) * w, rng.normal(size=d) * 0.1,
            1.0 + rng.normal(size=d) * 0.1, rng.normal(size=d) * 0.1,
            1.0 + rng.normal(size=d) * 0.1, rng.normal(size=d) * 0.1]


# (B, D, F, T): rows split for all three planes; columns split (T = 256);
# odd D and F, so no split
FFN_SHAPES = [(3, 32, 48, 8), (2, 8, 12, 256), (2, 7, 9, 5)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("shape", FFN_SHAPES)
def test_ffn_block_dropout_forward_and_backward_match_jax(shape, p, dtype):
    b, d, f, t = shape
    rng = np.random.default_rng(2)
    arrays = _ffn_arrays(rng, b, d, f, t, WSTD[dtype])
    dts = [dtype] * 3 + ["float32", dtype] + ["float32"] * 5
    dy = rng.normal(size=(b, d, t))
    seed = 2 ** 31 - 7 - 8192  # row 1 and up wrap the int32 sum

    @jax.jit
    def run(args, dy):
        out, vjp = jax.vjp(
            lambda *a: jffn.ffn_block(*a, jnp.int32(seed), p, True), *args)
        return out, vjp(dy)

    ref_out, ref = run(tuple(_jx(a, dd) for a, dd in zip(arrays, dts)),
                       _jx(dy, dtype))
    leaves = [_leaf(a, dd) for a, dd in zip(arrays, dts)]
    y = tffn.ffn_block(*leaves, seed=seed, dropout_p=p, train=True)
    _close(y, ref_out, dtype, "forward")
    y.backward(_tt(dy, dtype))
    names = ("dx", "do", "dW1", "db1", "dW2", "db2", "dg1", "dbe1", "dg2",
             "dbe2")
    for leaf, r, dd, name in zip(leaves, ref, dts, names):
        assert leaf.grad.dtype == TDT[dd], name
        _close(leaf.grad, r, dtype, name)
    # the attention-output cotangent is dx under mask O, no longer dx itself
    assert not torch.equal(leaves[0].grad, leaves[1].grad)
    # eval mode ignores the seed
    with torch.no_grad():
        a = tffn.ffn_block(*leaves, seed=seed, dropout_p=p, train=False)
        c = tffn.ffn_block(*leaves)
    assert torch.equal(a, c)


def test_ffn_saved_h1_is_sign_encoded_as_in_jax():
    b, d, f, t = FFN_SHAPES[0]
    rng = np.random.default_rng(3)
    arrays = _ffn_arrays(rng, b, d, f, t, 0.2)
    seed, p = 4242, 0.5
    (_, _, _, h1_ref, _) = jffn._ffn_fwd_call(
        *(_jx(a, "float32") for a in arrays[:2]), None,
        *(_jx(a, "float32") for a in arrays[2:]), jnp.int32(seed), p, True,
        save=True)
    out = tffn.ffn_block_fwd(*(_tt(a, "float32") for a in arrays), save=True,
                             seed=seed, dropout_p=p)
    h1 = out[3].numpy()
    np.testing.assert_allclose(h1, np.asarray(h1_ref), rtol=1e-4, atol=1e-5)
    keep_h = prng.keep_mask(prng.row_seeds(seed, b, 8192, tffn.SALT_H * 2048),
                            (f, t), p).numpy()
    assert (h1[~keep_h] <= 0).all() and (h1[keep_h] >= 0).all()


D_MODEL, HEADS = 32, 2
D_HEAD = D_MODEL // HEADS
L1, B = 3, 3
# (T, R, count, head, same_length): rows split, a partly filled ring; rows
# split, a full ring whose write position has wrapped; columns split
# (K = 256); no split (odd T, K / 2 no multiple of 128)
ATTN_CASES = [(8, 4, 16, 16, True), (8, 4, 32, 8, False),
              (64, 3, 192, 64, False), (5, 2, 10, 5, False)]


def _attention_case(t, r, dtype, seed):
    rng = np.random.default_rng(seed)
    w = WSTD[dtype]
    acts = [rng.normal(size=(B, HEADS, D_HEAD, t)) for _ in range(3)]
    wk, wv = (rng.normal(size=(D_MODEL, HEADS, D_HEAD)) * w for _ in range(2))
    r_kernel = rng.normal(size=(D_MODEL, D_MODEL)) * w
    rwb, rrb = (rng.normal(size=(HEADS, D_HEAD)) * 0.1 for _ in range(2))
    mem = rng.normal(size=(L1, r, B, D_MODEL, t))
    g = rng.normal(size=(B, HEADS, D_HEAD, t))
    return acts, wk, wv, r_kernel, rwb, rrb, mem, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("t,r,count,head,same_length", ATTN_CASES)
def test_attention_mem_dropout_forward_and_backward_match_jax(
        t, r, count, head, same_length, p, dtype):
    m = r * t
    (q, k_win, v_win), wk, wv, r_kernel, rwb, rrb, mem, g = _attention_case(
        t, r, dtype, 3 + count)
    reset = np.array([False, True, False])
    seed = 2 ** 31 - 1 - 4096  # rows 1 and 2 wrap the int32 sum
    scale = 1.0 / D_HEAD ** 0.5
    jdt = JDT[dtype]
    jpsi = jfa.ring_psi(jfa.key_trig_basis(m + t, D_MODEL, jdt), t,
                        jnp.int32(count), jnp.int32(head))
    jw_r = jfa.pack_r_kernel(_jx(r_kernel, dtype), HEADS)
    args = (_jx(q, dtype), _jx(wk, dtype), _jx(wv, dtype), _jx(k_win, dtype),
            _jx(v_win, dtype), jw_r, _jx(rwb, "float32"), _jx(rrb, "float32"))

    @jax.jit
    def run(args, mem, psi, g):
        def f(q, wk3, wv3, k_win, v_win, w_r, rwb, rrb):
            return jfa.attention_mem(
                q, mem, 1, wk3, wv3, k_win, v_win, w_r, psi, rwb, rrb,
                jnp.int32(count), jnp.int32(head), jnp.asarray(reset),
                d_model=D_MODEL, scale=scale, same_length=same_length,
                dropout_p=p, dropout_seed=jnp.int32(seed), train=True)
        out, vjp = jax.vjp(f, *args)
        return out, vjp(g)

    ref_out, ref = run(args, _jx(mem, dtype), jpsi, _jx(g, dtype))
    leaves = [_leaf(q, dtype), _leaf(wk, dtype), _leaf(wv, dtype),
              _leaf(k_win, dtype), _leaf(v_win, dtype),
              tfa.pack_r_kernel(_leaf(r_kernel, dtype), HEADS).detach()
              .requires_grad_(True),
              _leaf(rwb, "float32"), _leaf(rrb, "float32")]
    tpsi = tfa.ring_psi(tfa.key_trig_basis(m + t, D_MODEL, TDT[dtype]), t,
                        count, head)
    out = tfa.attention_mem(
        leaves[0], _tt(mem, dtype), 1, leaves[1], leaves[2], leaves[3],
        leaves[4], leaves[5], tpsi, leaves[6], leaves[7], count, head,
        torch.from_numpy(reset), d_model=D_MODEL, scale=scale,
        same_length=same_length, dropout_p=p, dropout_seed=seed, train=True)
    _close(out, ref_out, dtype, "forward")
    out.backward(_tt(g, dtype))
    names = ("dq", "dWk", "dWv", "dk_win", "dv_win", "dW_r", "d r_w_bias",
             "d r_r_bias")
    for leaf, rr, name in zip(leaves, ref, names):
        _close(leaf.grad, rr, dtype, name)
    # the same call without autograd takes the same mask
    with torch.no_grad():
        again = tfa.attention_mem(
            leaves[0], _tt(mem, dtype), 1, leaves[1], leaves[2], leaves[3],
            leaves[4], leaves[5], tpsi, leaves[6], leaves[7], count, head,
            torch.from_numpy(reset), d_model=D_MODEL, scale=scale,
            same_length=same_length, dropout_p=p, dropout_seed=seed,
            train=True)
    assert torch.equal(again, out.detach())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("t", [8, 256, 5])
def test_attention_dropout_forward_matches_jax_and_backward_names_kernel_3(
        t, p, dtype):
    """The no-memory attention at dropout: the forward, and (since kernel 3
    of the table of TPU kernels has its counterpart) the backward against
    ``jax.vjp`` from the same seed, in every split of the mask's plane."""
    (q, k_win, v_win), _, _, r_kernel, rwb, rrb, _, g = _attention_case(
        t, 1, dtype, 11)
    reset = np.array([False, True, False])
    seed, scale = 31337, 1.0 / D_HEAD ** 0.5

    @jax.jit
    def run(args, psi, g):
        out, vjp = jax.vjp(lambda q, k, v, w_r, rwb, rrb: jfa.attention(
            q, k, v, w_r, psi, rwb, rrb, jnp.asarray(reset), d_model=D_MODEL,
            scale=scale, same_length=False, dropout_p=p,
            dropout_seed=jnp.int32(seed), train=True), *args)
        return out, vjp(g)

    ref, ref_grads = run(
        (_jx(q, dtype), _jx(k_win, dtype), _jx(v_win, dtype),
         jfa.pack_r_kernel(_jx(r_kernel, dtype), HEADS), _jx(rwb, "float32"),
         _jx(rrb, "float32")), jfa.key_trig_basis(t, D_MODEL, JDT[dtype]),
        _jx(g, dtype))
    w_r = tfa.pack_r_kernel(_tt(r_kernel, dtype), HEADS)
    psi = tfa.key_trig_basis(t, D_MODEL, TDT[dtype])
    call = dict(d_model=D_MODEL, scale=scale, same_length=False, dropout_p=p,
                dropout_seed=seed, train=True)
    out = tfa.attention(_tt(q, dtype), _tt(k_win, dtype), _tt(v_win, dtype),
                        w_r, psi, _tt(rwb, "float32"), _tt(rrb, "float32"),
                        torch.from_numpy(reset), **call)
    _close(out, ref, dtype, "forward")
    leaves = [_leaf(q, dtype), _leaf(k_win, dtype), _leaf(v_win, dtype),
              w_r.clone().requires_grad_(True), _leaf(rwb, "float32"),
              _leaf(rrb, "float32")]
    again = tfa.attention(*leaves[:4], psi, *leaves[4:],
                          torch.from_numpy(reset), **call)
    assert torch.equal(again.detach(), out)  # the same mask under autograd
    again.backward(_tt(g, dtype))
    for leaf, r, name in zip(leaves, ref_grads, (
            "dq", "dk", "dv", "dW_r", "d r_w_bias", "d r_r_bias")):
        if dtype == "bfloat16" and name.endswith("bias"):
            # the port's row term is rowsum(dO * O) over the bf16-rounded
            # O, the reference's rowsum(probs * dP) in f32: a row of one or
            # two keys, whose ds cancels to 0 in the reference, keeps O's
            # rounding error, and at T = 5 such rows are a third of the sum
            # over queries that a bias gradient is: 5e-2 of the largest value
            ref = np.asarray(r, np.float32)
            np.testing.assert_allclose(leaf.grad.float().numpy(), ref,
                                       rtol=2e-2,
                                       atol=5e-2 * float(np.abs(ref).max()),
                                       err_msg=name)
            continue
        _close(leaf.grad, r, dtype, name)
