"""The reference's fast numerics in the port, against the JAX package on the
CPU: 8-bit dropout draws (``COMMU_DROPOUT_BITS=8``), the int8 BD forward
(``COMMU_BD_INT8=1``) and the int8 dphi backward (``COMMU_BD_INT8_BWD=1``).

The JAX side runs its Pallas kernels in interpret mode under
``monkeypatch.setenv``, as ``tests/test_fused_attention.py`` does; it reads
the variables while it traces, so every mode gets a jit of its own.  The
port reads the same variables at each call and runs its kernels' plain twins
(CPU tensors).  Inputs come from numpy with a fixed seed.

Tolerances.  Masks and quantisers: bit for bit.  Ops: the tolerances of
``tests/test_torch_train_ops.py`` (f32: rtol 1e-4, atol 1e-5 of the largest
reference magnitude; bf16: 2e-2 of it), except that an int8 form may sit one
quantisation step off where a float lands on a rounding tie (the integer sum
is exact on both sides, the float operand differs in its last bits): there
at most 1 element in 100 may miss the tolerance, and in f32 the port's mean
absolute distance to JAX's int8 result is held to a tenth of JAX's own
int8-to-exact distance, which proves that the int8 form is what ran (see
``_tenth`` for bf16).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commu_tpu.ops import fused_attention as jfa
from commu_tpu_torch.ops import fused_attention as tfa
from commu_tpu_torch.ops import prng

D_MODEL, HEADS = 32, 2
D_HEAD = D_MODEL // HEADS
T, R = 8, 4
M = R * T
L1, B = 3, 3
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 2e-2)}
WSTD = {"float32": 0.2, "bfloat16": 0.05}
MEM_STATES = [(0, 0, False), (16, 16, True), (M, 8, False)]
FAST = {"COMMU_BD_INT8": "1", "COMMU_BD_INT8_BWD": "1",
        "COMMU_DROPOUT_BITS": "8"}
# one plane per branch of random_keep at 8 bits, in its order: columns
# quartered, rows quartered (twice: the training shape's planes), columns
# halved, rows halved, the whole plane
PLANES_8 = [((128, 1024), (0, 256, 8)), ((128, 1152), (1, 32, 8)),
            ((500, 128), (1, 125, 8)), ((6, 256), (0, 128, 16)),
            ((6, 1152), (1, 3, 16)), ((125, 128), (2, 0, 16))]
SEEDS = (0, 7, 2 ** 31 - 3)


def _setenv(monkeypatch, env):
    for name in FAST:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)


def _jx(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32)).astype(JDT[dtype])


def _tt(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dtype])


def _leaf(a, dtype):
    return _tt(a, dtype).requires_grad_(True)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(ours, ref, dtype, name, ties=0.0, extra=0.0):
    """``ours`` (torch) against ``ref`` (JAX): rtol, and atol as a fraction
    of the largest reference magnitude plus ``extra``; ``ties`` is the share
    of elements that may miss it (an int8 form's rounding ties)."""
    rtol, frac = TOL[dtype]
    ours, ref = _np(ours), _np(ref)
    assert ours.shape == ref.shape, name
    bound = rtol * np.abs(ref) + frac * float(np.abs(ref).max()) + extra
    missed = float((np.abs(ours - ref) > bound).mean())
    assert missed <= ties, (name, missed, float(np.abs(ours - ref).max()))


# ---- masks ---------------------------------------------------------------

@pytest.mark.parametrize("p", [0.1, 0.999])
@pytest.mark.parametrize("shape,branch", PLANES_8)
def test_keep_mask_8_bits_equals_the_jax_hash_bit_for_bit(monkeypatch, shape,
                                                          branch, p):
    _setenv(monkeypatch, {"COMMU_DROPOUT_BITS": "8"})
    assert prng.dropout_bits() == 8
    assert prng.draw_geometry(*shape) == branch
    assert prng.dropout_threshold(p) == (26 if p == 0.1 else 255)
    for seed in SEEDS:
        jfa._prng_seed(jnp.int32(seed) + jnp.int32(5 * 16384))
        ref = np.asarray(jfa.random_keep(shape, p))
        ours = prng.keep_mask(seed + 5 * 16384, shape, p)
        np.testing.assert_array_equal(ours.numpy(), ref, err_msg=str(seed))
        # the width as an argument is the width from the environment
        assert torch.equal(ours, prng.keep_mask(seed + 5 * 16384, shape, p,
                                                bits=8))
    if p == 0.1 and shape[0] * shape[1] >= 2 ** 14:
        assert abs((1.0 - ref.mean()) - 26 / 256) < 5e-3


@pytest.mark.parametrize("value", [None, "16"])
def test_keep_mask_at_16_bits_or_unset_is_the_default_mask(monkeypatch,
                                                           value):
    _setenv(monkeypatch, {} if value is None else
            {"COMMU_DROPOUT_BITS": value})
    assert prng.dropout_bits() == 16
    for shape, _ in PLANES_8:
        jfa._prng_seed(jnp.int32(11))
        ref = np.asarray(jfa.random_keep(shape, 0.1))
        ours = prng.keep_mask(11, shape, 0.1)
        np.testing.assert_array_equal(ours.numpy(), ref)
        assert torch.equal(ours, prng.keep_mask(11, shape, 0.1, bits=16))
        if prng.draw_geometry(*shape, 8)[2] == 8:   # another word layout
            assert not torch.equal(ours,
                                   prng.keep_mask(11, shape, 0.1, bits=8))
    assert prng.kernel_args(5, 0.1) == (5, 6554, prng.keep_scale_for(0.1), 16)


def test_rates_and_scales_follow_the_reference_at_both_widths(monkeypatch):
    for bits in ("8", "16"):
        _setenv(monkeypatch, {"COMMU_DROPOUT_BITS": bits})
        for p in (0.0, 0.1, 0.25, 0.5, 0.999, 1.0):
            assert prng.effective_dropout_p(p) == jfa.effective_dropout_p(p)
            if 0.0 < p < 1.0:
                assert prng.keep_scale_for(p) == jfa.keep_scale_for(p, True)
        assert prng.keep_scale_for(0.1, train=False) == 1.0
    assert prng.effective_dropout_p(0.1, bits=8) == 26 / 256
    assert prng.keep_scale_for(0.1, bits=8) == 1.0 / (1.0 - 26 / 256)
    assert prng.kernel_args(2 ** 31 + 5, 0.1, 8) == (
        5 - 2 ** 31, 26, 1.0 / (1.0 - 26 / 256), 8)
    assert prng.kernel_args(1, 1.0, 8)[1] == 255
    _setenv(monkeypatch, {"COMMU_DROPOUT_BITS": "4"})
    with pytest.raises(ValueError):
        prng.dropout_bits()
    with pytest.raises(ValueError):
        prng.keep_mask(0, (4, 4), 0.1, bits=4)


# ---- quantisers ----------------------------------------------------------

def _tie_rows(rng, rows, cols, top):
    """f32 rows whose maximum is ``top``, so x * (127 / top) lands on
    integers and halves: every rounding is a tie or sits beside one."""
    steps = rng.integers(-254, 255, size=(rows, cols)).astype(np.float32)
    x = steps * np.float32(top / 254.0)
    x[:, 0] = top
    return x


def test_quantize_psi_int8_equals_the_reference(monkeypatch):
    rng = np.random.default_rng(0)
    psi = rng.uniform(-1.0, 1.0, size=(64, 40)).astype(np.float32)
    psi[0, :8] = (np.arange(8) - 4 + 0.5) / 127.0     # ties
    psi[1, :4] = [1.0 / 0.9, -1.0 / 0.9, 1.3, -7.0]   # above 1: clipped
    psi[2] = 0.0
    for dtype in ("float32", "bfloat16"):
        ref = np.asarray(jfa.quantize_psi_int8(_jx(psi, dtype)))
        ours = tfa.quantize_psi_int8(_tt(psi, dtype))
        assert ours.dtype == torch.int8 and ref.dtype == np.int8
        np.testing.assert_array_equal(ours.numpy(), ref)
        assert ours.abs().max() == 127 and int(ours[1, 2]) == 127


def test_phi_rows_quantise_and_scale_back_as_bd_matmul_does():
    rng = np.random.default_rng(1)
    phi = np.concatenate([
        rng.normal(size=(5, 64)).astype(np.float32),
        _tie_rows(rng, 4, 64, 0.75), np.zeros((1, 64), np.float32)])
    psi_q = rng.integers(-127, 128, size=(64, 24)).astype(np.int8)
    ref = np.asarray(jfa._bd_matmul(jnp.asarray(phi), None,
                                    jnp.asarray(psi_q), jnp.float32))
    phi_q, amax = tfa.quantize_phi_rows(torch.from_numpy(phi))
    # the reference's rounding, replayed with its own expressions
    j_amax = jnp.max(jnp.abs(jnp.asarray(phi)), axis=1, keepdims=True)
    j_q = jnp.round(jnp.asarray(phi) * (127.0 / jnp.maximum(j_amax, 1e-20)))
    np.testing.assert_array_equal(phi_q.numpy(), np.asarray(j_q, np.int8))
    assert int(phi_q[-1].abs().max()) == 0        # the all-zero row
    bd = tfa._int_matmul(phi_q, torch.from_numpy(psi_q)) * \
        (amax * (1.0 / (127.0 * 127.0)))
    np.testing.assert_array_equal(bd.numpy(), ref)


def test_ds_rows_quantise_as_bwd_stage_b_does():
    rng = np.random.default_rng(2)
    ds = np.concatenate([
        rng.normal(size=(5, 40)).astype(np.float32) * 1e-3,
        _tie_rows(rng, 4, 40, 0.03125), np.zeros((1, 40), np.float32)])
    ref_q, ref_sc = jfa._quant_rows(jnp.asarray(ds))
    ds_q, sc = tfa.quantize_ds_rows(torch.from_numpy(ds))
    np.testing.assert_array_equal(ds_q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(ref_sc))
    assert int(ds_q[-1].abs().max()) == 0
    psi_q = rng.integers(-127, 128, size=(64, 40)).astype(np.int8)
    # dphi as _bwd_stage_b :981-984 forms it
    dphi_i = jax.lax.dot_general(ref_q, jnp.asarray(psi_q),
                                 (((1,), (1,)), ((), ())),
                                 preferred_element_type=jnp.int32)
    ref = dphi_i.astype(jnp.float32) * (ref_sc * (1.0 / 127.0))
    ours = tfa._int_matmul(ds_q, torch.from_numpy(psi_q).t()) * \
        (sc * (1.0 / 127.0))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_mode_switches_read_the_environment_at_each_call(monkeypatch):
    _setenv(monkeypatch, {})
    assert not tfa.bd_int8() and not tfa.bd_int8_bwd()
    _setenv(monkeypatch, FAST)
    assert tfa.bd_int8() and tfa.bd_int8_bwd() and prng.dropout_bits() == 8
    _setenv(monkeypatch, {"COMMU_BD_INT8": "0", "COMMU_BD_INT8_BWD": "0"})
    assert not tfa.bd_int8() and not tfa.bd_int8_bwd()


# ---- attention against JAX -------------------------------------------------

def _attention_case(dtype, seed):
    rng = np.random.default_rng(seed)
    w = WSTD[dtype]
    acts = [rng.normal(size=(B, HEADS, D_HEAD, T)) for _ in range(3)]
    wk, wv = (rng.normal(size=(D_MODEL, HEADS, D_HEAD)) * w for _ in range(2))
    r_kernel = rng.normal(size=(D_MODEL, D_MODEL)) * w
    rwb, rrb = (rng.normal(size=(HEADS, D_HEAD)) * 0.1 for _ in range(2))
    mem = rng.normal(size=(L1, R, B, D_MODEL, T))
    g = rng.normal(size=(B, HEADS, D_HEAD, T))
    return acts, wk, wv, r_kernel, rwb, rrb, mem, g


def _jax_mem(case, dtype, count, head, same_length, p, seed):
    """(out, grads) of the JAX package's attention_mem under the current
    environment: a fresh jit, since the modes are read while tracing."""
    (q, k_win, v_win), wk, wv, r_kernel, rwb, rrb, mem, g = case
    jdt = JDT[dtype]
    psi = jfa.ring_psi(jfa.key_trig_basis(M + T, D_MODEL, jdt), T,
                       jnp.int32(count), jnp.int32(head))
    args = (_jx(q, dtype), _jx(wk, dtype), _jx(wv, dtype), _jx(k_win, dtype),
            _jx(v_win, dtype), jfa.pack_r_kernel(_jx(r_kernel, dtype), HEADS),
            _jx(rwb, "float32"), _jx(rrb, "float32"))
    reset = jnp.asarray(np.array([False, True, False]))

    def run(args, mem, g):
        def f(q, wk3, wv3, k_win, v_win, w_r, rwb, rrb):
            return jfa.attention_mem(
                q, mem, 1, wk3, wv3, k_win, v_win, w_r, psi, rwb, rrb,
                jnp.int32(count), jnp.int32(head), reset, d_model=D_MODEL,
                scale=1.0 / D_HEAD ** 0.5, same_length=same_length,
                dropout_p=p, dropout_seed=jnp.int32(seed), train=True)
        out, vjp = jax.vjp(f, *args)
        return out, vjp(g)
    return jax.jit(run)(args, _jx(mem, dtype), _jx(g, dtype))


def _torch_mem(case, dtype, count, head, same_length, p, seed):
    (q, k_win, v_win), wk, wv, r_kernel, rwb, rrb, mem, g = case
    leaves = [_leaf(q, dtype), _leaf(wk, dtype), _leaf(wv, dtype),
              _leaf(k_win, dtype), _leaf(v_win, dtype),
              tfa.pack_r_kernel(_tt(r_kernel, dtype), HEADS).detach()
              .requires_grad_(True),
              _leaf(rwb, "float32"), _leaf(rrb, "float32")]
    psi = tfa.ring_psi(tfa.key_trig_basis(M + T, D_MODEL, TDT[dtype]), T,
                       count, head)
    out = tfa.attention_mem(
        leaves[0], _tt(mem, dtype), 1, leaves[1], leaves[2], leaves[3],
        leaves[4], leaves[5], psi, leaves[6], leaves[7], count, head,
        torch.from_numpy(np.array([False, True, False])), d_model=D_MODEL,
        scale=1.0 / D_HEAD ** 0.5, same_length=same_length, dropout_p=p,
        dropout_seed=seed, train=True)
    out.backward(_tt(g, dtype))
    return out, [leaf.grad for leaf in leaves]


MEM_NAMES = ("dq", "dWk", "dWv", "dk_win", "dv_win", "dW_r", "d r_w_bias",
             "d r_r_bias")
# what the int8 dphi product reaches: the position path.  dk, dv, dWk, dWv
# and d r_w_bias see the unquantised ds alone.
POSITION = ("dq", "dW_r", "d r_r_bias")


def _mean_gap(a, b):
    return float(np.abs(_np(a) - _np(b)).mean())


def _int8_noise(ref, exact, dtype, name):
    """What a bf16 position gradient may miss its tolerance by under the int8
    dphi: the two sides' ds differ by bf16 roundings (the port rebuilds P
    from the f32 scores, the reference saved it in bf16), so their quantised
    copies differ in many places, not on ties alone, and the results sit as
    far apart as quantisation noise puts them: twice the largest distance
    between JAX's int8 and JAX's exact result.  Nothing in f32."""
    if dtype == "float32" or name not in POSITION:
        return 0.0
    return 2.0 * float(np.abs(_np(ref) - _np(exact)).max())


def _tenth(ours, ref, exact, dtype, name):
    """The port's mean absolute distance to JAX's int8 result is at most a
    tenth of JAX's own int8-to-exact distance.  Held in f32 only: a bf16
    result is rounded to 8 bits of mantissa on both sides, and that step
    (about 4e-3 of a value) is wider than the distance the int8 product
    moves it by, so in bf16 the two int8 results are held to the dtype's
    tolerance alone."""
    gap = _mean_gap(ref, exact)
    assert gap > 0.0, name
    if dtype == "float32":
        assert _mean_gap(ours, ref) <= 0.1 * gap, (name, gap)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("count,head,same_length", MEM_STATES)
def test_attention_mem_fast_mode_matches_jax(monkeypatch, count, head,
                                             same_length, dtype):
    """Forward under COMMU_BD_INT8=1 and gradients under
    COMMU_BD_INT8_BWD=1, with 8-bit masks at dropout 0.1 drawn on both sides
    from one seed (no patched masks: they are bit-equal)."""
    case = _attention_case(dtype, 3 + count)
    p, seed = 0.1, 2 ** 31 - 1 - 4096   # rows 1 and up wrap the int32 sum
    _setenv(monkeypatch, {"COMMU_DROPOUT_BITS": "8"})
    exact_out, exact = _jax_mem(case, dtype, count, head, same_length, p, seed)
    t_exact_out, t_exact = _torch_mem(case, dtype, count, head, same_length,
                                      p, seed)
    _setenv(monkeypatch, FAST)
    ref_out, ref = _jax_mem(case, dtype, count, head, same_length, p, seed)
    out, grads = _torch_mem(case, dtype, count, head, same_length, p, seed)

    _close(out, ref_out, dtype, "forward", ties=0.01)
    _tenth(out, ref_out, exact_out, dtype, "forward")
    for grad, r, e, name in zip(grads, ref, exact, MEM_NAMES):
        if count == 0 and name in ("dWk", "dWv"):
            assert float(grad.abs().max()) == 0.0
            continue
        _close(grad, r, dtype, name, ties=0.01,
               extra=_int8_noise(r, e, dtype, name))
        if name in POSITION:
            _tenth(grad, r, e, dtype, name)

    # the backward lever alone leaves dk, dv, dWk, dWv and d r_w_bias the
    # exact mode's, bit for bit
    _setenv(monkeypatch, {"COMMU_DROPOUT_BITS": "8",
                          "COMMU_BD_INT8_BWD": "1"})
    bwd_out, bwd = _torch_mem(case, dtype, count, head, same_length, p, seed)
    assert torch.equal(bwd_out, t_exact_out)
    for grad, e, name in zip(bwd, t_exact, MEM_NAMES):
        assert torch.equal(grad, e) == (name not in POSITION), name


def _jax_window(case, dtype, same_length, p, seed):
    (q, k_win, v_win), _, _, r_kernel, rwb, rrb, _, g = case
    psi = jfa.key_trig_basis(T, D_MODEL, JDT[dtype])
    args = (_jx(q, dtype), _jx(k_win, dtype), _jx(v_win, dtype),
            jfa.pack_r_kernel(_jx(r_kernel, dtype), HEADS),
            _jx(rwb, "float32"), _jx(rrb, "float32"))
    reset = jnp.asarray(np.array([False, True, False]))

    def run(args, g):
        def f(q, k_win, v_win, w_r, rwb, rrb):
            return jfa.attention(
                q, k_win, v_win, w_r, psi, rwb, rrb, reset, d_model=D_MODEL,
                scale=1.0 / D_HEAD ** 0.5, same_length=same_length,
                dropout_p=p, dropout_seed=jnp.int32(seed), train=True)
        out, vjp = jax.vjp(f, *args)
        return out, vjp(g)
    return jax.jit(run)(args, _jx(g, dtype))


def _torch_window(case, dtype, same_length, p, seed):
    (q, k_win, v_win), _, _, r_kernel, rwb, rrb, _, g = case
    leaves = [_leaf(q, dtype), _leaf(k_win, dtype), _leaf(v_win, dtype),
              tfa.pack_r_kernel(_tt(r_kernel, dtype), HEADS).detach()
              .requires_grad_(True),
              _leaf(rwb, "float32"), _leaf(rrb, "float32")]
    out = tfa.attention(
        leaves[0], leaves[1], leaves[2], leaves[3],
        tfa.key_trig_basis(T, D_MODEL, TDT[dtype]), leaves[4], leaves[5],
        torch.from_numpy(np.array([False, True, False])), d_model=D_MODEL,
        scale=1.0 / D_HEAD ** 0.5, same_length=same_length, dropout_p=p,
        dropout_seed=seed, train=True)
    out.backward(_tt(g, dtype))
    return out, [leaf.grad for leaf in leaves]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("same_length", [False, True])
def test_attention_fast_mode_matches_jax(monkeypatch, same_length, dtype):
    """The same over the window alone (training without XL memory)."""
    case = _attention_case(dtype, 11)
    p, seed = 0.1, 991
    names = ("dq", "dk", "dv", "dW_r", "d r_w_bias", "d r_r_bias")
    _setenv(monkeypatch, {"COMMU_DROPOUT_BITS": "8"})
    exact_out, exact = _jax_window(case, dtype, same_length, p, seed)
    _, t_exact = _torch_window(case, dtype, same_length, p, seed)
    _setenv(monkeypatch, FAST)
    ref_out, ref = _jax_window(case, dtype, same_length, p, seed)
    out, grads = _torch_window(case, dtype, same_length, p, seed)
    _close(out, ref_out, dtype, "forward", ties=0.01)
    _tenth(out, ref_out, exact_out, dtype, "forward")
    for grad, r, e, name in zip(grads, ref, exact, names):
        _close(grad, r, dtype, name, ties=0.01,
               extra=_int8_noise(r, e, dtype, name))
        if name in POSITION:
            _tenth(grad, r, e, dtype, name)
    _setenv(monkeypatch, {"COMMU_DROPOUT_BITS": "8",
                          "COMMU_BD_INT8_BWD": "1"})
    _, bwd = _torch_window(case, dtype, same_length, p, seed)
    for grad, e, name in zip(bwd, t_exact, names):
        assert torch.equal(grad, e) == (name not in POSITION), name


def test_eval_windows_run_the_int8_forward_too(monkeypatch):
    """The flag does not depend on ``train``: a forward without autograd
    under COMMU_BD_INT8=1 is the int8 one, on both sides."""
    case = _attention_case("float32", 5)
    (q, k_win, v_win), wk, wv, r_kernel, rwb, rrb, mem, _ = case

    def ours():
        with torch.no_grad():
            return tfa.attention_mem(
                _tt(q, "float32"), _tt(mem, "float32"), 1, _tt(wk, "float32"),
                _tt(wv, "float32"), _tt(k_win, "float32"),
                _tt(v_win, "float32"),
                tfa.pack_r_kernel(_tt(r_kernel, "float32"), HEADS),
                tfa.ring_psi(tfa.key_trig_basis(M + T, D_MODEL, torch.float32),
                             T, 16, 16),
                _tt(rwb, "float32"), _tt(rrb, "float32"), 16, 16, None,
                d_model=D_MODEL, scale=0.25, same_length=True)

    def theirs():
        psi = jfa.ring_psi(jfa.key_trig_basis(M + T, D_MODEL, jnp.float32), T,
                           jnp.int32(16), jnp.int32(16))
        return jfa.attention_mem(
            _jx(q, "float32"), _jx(mem, "float32"), 1, _jx(wk, "float32"),
            _jx(wv, "float32"), _jx(k_win, "float32"), _jx(v_win, "float32"),
            jfa.pack_r_kernel(_jx(r_kernel, "float32"), HEADS), psi,
            _jx(rwb, "float32"), _jx(rrb, "float32"), jnp.int32(16),
            jnp.int32(16), None, d_model=D_MODEL, scale=0.25,
            same_length=True)

    _setenv(monkeypatch, {})
    exact, j_exact = ours(), theirs()
    _setenv(monkeypatch, {"COMMU_BD_INT8": "1"})
    fast, j_fast = ours(), theirs()
    assert not torch.equal(fast, exact)
    _close(fast, j_fast, "float32", "eval forward", ties=0.01)
    assert _mean_gap(fast, j_fast) <= 0.1 * _mean_gap(j_fast, j_exact)


def test_projecting_forward_refuses_the_int8_bd(monkeypatch):
    """COMMU_BD_INT8=1 with COMMU_PROJ_IN_FWD=1 raises, as the reference's
    ``_fused_fwd_proj`` does; it never runs the exact product in silence."""
    case = _attention_case("float32", 6)
    _setenv(monkeypatch, {"COMMU_BD_INT8": "1"})
    monkeypatch.setenv("COMMU_PROJ_IN_FWD", "1")
    with pytest.raises(NotImplementedError, match="COMMU_BD_INT8"):
        _torch_mem(case, "float32", 16, 16, True, 0.0, 0)
    with pytest.raises(NotImplementedError, match="COMMU_BD_INT8"):
        _jax_mem(case, "float32", 16, 16, True, 0.0, 0)
    _setenv(monkeypatch, {})
    _torch_mem(case, "float32", 16, 16, True, 0.0, 0)   # the probe alone runs


# ---- convergence: the fast arm against the precise arm --------------------

def _markov_corpus(num_seqs, vocab, seed=0, min_len=40, max_len=120, pad=0,
                   eos=1):
    """The synthetic corpus of ``scripts/convergence_parity.py``: a sparse
    random first-order Markov chain over the non-special tokens, 6 random
    successors a token with Dirichlet probabilities."""
    rng = np.random.default_rng(seed)
    support = vocab - 2
    succ = rng.integers(2, vocab, size=(support, 6))
    prob = rng.dirichlet(np.ones(6) * 0.4, size=support)
    inputs, targets = [], []
    for _ in range(num_seqs):
        n = int(rng.integers(min_len, max_len))
        seq = [int(rng.integers(2, vocab))]
        for _ in range(n - 1):
            row = seq[-1] - 2
            seq.append(int(rng.choice(succ[row], p=prob[row])))
        seq.append(eos)
        inputs.append(np.array(seq[:-1], np.int32))
        targets.append(np.array(seq[1:], np.int32))
    return inputs, targets


def test_fast_mode_converges_as_the_precise_mode_does(tmp_path, monkeypatch):
    """The evidence the default of ``commu_tpu_torch.train`` rests on: from
    one seed and one corpus, the port trained with the three levers ends
    within 2% of the val NLL of the port trained exact, after the NLL has
    fallen well below its start."""
    from commu_tpu_torch.config import (EvaluateConfig, ModelConfig,
                                        TrainConfig, TrainingConfig)
    from commu_tpu_torch.data.dataset import save_corpus
    from commu_tpu_torch.training import Trainer
    from commu_tpu_torch.vocab.event_tokens import VOCAB_SIZE

    inputs, targets = _markov_corpus(160, 64, seed=0, min_len=30, max_len=60)
    save_corpus(str(tmp_path / "npy"), "train", inputs[:128], targets[:128])
    save_corpus(str(tmp_path / "npy"), "val", inputs[128:], targets[128:])
    assert max(int(x.max()) for x in inputs) < VOCAB_SIZE
    cfg = TrainingConfig(
        model=ModelConfig(num_layers=2, units=32, num_heads=2, inner_size=64,
                          dropout=0.1, attention_dropout=0.1),
        train=TrainConfig(batch_size=16, batch_chunk=1, tgt_length=16,
                          mem_length=32, lr=3e-3, warmup_step=20, max_step=150,
                          log_interval=1000, eval_interval=10 ** 6, seed=3),
        evaluate=EvaluateConfig(batch_size=8, tgt_length=16, mem_length=32))

    def arm(env, name):
        _setenv(monkeypatch, env)
        trainer = Trainer(str(tmp_path / "npy"), cfg, device="cpu",
                          model_dtype=torch.float32,
                          work_dir=str(tmp_path / name))
        tokens, start = trainer.evaluate("valid")
        trainer.train()
        _, end = trainer.evaluate("valid")
        return start / tokens, end / tokens

    # one thread: 300 steps of products this small cost more in hand-offs
    # between threads than in arithmetic, above all beside other workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        start, precise = arm({"COMMU_BD_INT8": "0", "COMMU_BD_INT8_BWD": "0",
                              "COMMU_DROPOUT_BITS": "16"}, "precise")
        _, fast = arm(FAST, "fast")
    finally:
        torch.set_num_threads(threads)
    assert precise < 0.75 * start, (start, precise)
    assert fast != precise
    assert abs(fast - precise) / precise <= 0.02, (start, precise, fast)
