"""The reference's three forward levers of its attention kernels in the
port, against the JAX package on the CPU: ``COMMU_SOFTMAX=clamp``,
``COMMU_DEFER_NORM=1`` and ``COMMU_SCALE_HOIST=1`` (the two int8 backward
levers: ``tests/test_torch_levers_int8.py``), and the quantisers of all
five.

The JAX side runs its Pallas kernels in interpret mode under
``monkeypatch.setenv`` with a fresh ``jax.jit`` per mode, as
``tests/test_torch_numerics_modes.py`` does, at its sizes; the port reads
the same variables at each call and runs its kernels' plain twins.  Each
lever runs in f32 and bf16, over a full ring of XL memory and over the
window alone, in both numerics modes: exact (the library default: exact
products, 16-bit masks) and fast (``COMMU_BD_INT8``, ``COMMU_BD_INT8_BWD``,
8-bit masks); the projecting forward (``COMMU_PROJ_IN_FWD=1``, exact mode
only) and the forward without autograd (an eval window) too.

Tolerances: those of ``tests/test_torch_numerics_modes.py``'s docstring
(f32 rtol 1e-4 and atol 1e-5 of the largest reference magnitude, bf16 2e-2
of it; in the fast mode 1 element in 100 may miss on an int8 rounding tie,
and a bf16 position gradient may miss by twice the distance the int8 dphi
puts between JAX's two modes).  Quantisers: bit for bit.
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

from test_torch_numerics_modes import (FAST, HEADS, M, MEM_NAMES, T, _close,
                                       _int8_noise, _attention_case, _jax_mem,
                                       _jax_window, _jx, _np, _torch_mem,
                                       _torch_window, _tt, _tie_rows)
import torch_cpu_threads  # noqa: F401  (one intra-op thread)

FORWARD = {"clamp": {"COMMU_SOFTMAX": "clamp"},
           "defer": {"COMMU_DEFER_NORM": "1"},
           "hoist": {"COMMU_SCALE_HOIST": "1"}}
INT8 = {"int8_dq": {"COMMU_INT8_DQ": "1"}, "int8_dk": {"COMMU_INT8_DK": "1"}}
MODES = {"exact": {}, "fast": FAST}
LEVER_VARS = ("COMMU_SOFTMAX", "COMMU_DEFER_NORM", "COMMU_SCALE_HOIST",
              "COMMU_INT8_DQ", "COMMU_INT8_DK", "COMMU_PROJ_IN_FWD")
WINDOW_NAMES = ("dq", "dk", "dv", "dW_r", "d r_w_bias", "d r_r_bias")
RING = (M, 8, False)  # a full ring, its head at slot 8
P, SEED = 0.1, 2 ** 31 - 1 - 4096  # rows 1 and up wrap the int32 seed sum


def set_env(monkeypatch, *envs):
    """Exactly the variables of ``envs`` among the levers and the modes."""
    for name in LEVER_VARS + tuple(FAST):
        monkeypatch.delenv(name, raising=False)
    for env in envs:
        for name, value in env.items():
            monkeypatch.setenv(name, value)


# JAX's (out, grads) by (dtype, ring, the case's seed, every COMMU_*
# variable set): JAX reads the variables while it traces, so a result
# serves only calls under the same ones; the cases of this file (and of
# test_torch_levers_int8.py) ask for some of them more than once
_JAX = {}


def _numerics_env():
    return tuple(sorted((name, value) for name, value in os.environ.items()
                        if name.startswith("COMMU_")))


def run_jax(case_seed, dtype, ring):
    """JAX's (out, grads) on ``_attention_case(dtype, case_seed)`` under the
    current environment (computed once per environment)."""
    key = (dtype, ring, case_seed, _numerics_env())
    if key not in _JAX:
        case = _attention_case(dtype, case_seed)
        _JAX[key] = (_jax_mem(case, dtype, *RING, P, SEED) if ring else
                     _jax_window(case, dtype, False, P, SEED))
    return _JAX[key]


def run_port(case_seed, dtype, ring):
    """The port's (out, grads) on the same case under the current
    environment."""
    case = _attention_case(dtype, case_seed)
    if ring:
        return _torch_mem(case, dtype, *RING, P, SEED)
    return _torch_window(case, dtype, False, P, SEED)


def run_both(case_seed, dtype, ring):
    """(JAX (out, grads), port (out, grads)) under the current environment."""
    return run_jax(case_seed, dtype, ring), run_port(case_seed, dtype, ring)


def hold(monkeypatch, lever_env, mode, dtype, ring, affected=()):
    """The port against JAX with ``lever_env`` in ``mode``.  ``affected``:
    the gradients an int8 lever quantises; in bf16 each may miss by twice
    the distance the lever puts between JAX's results (the two sides' ds
    differ by bf16 roundings, so their quantised copies differ in many
    places), in f32 on ties only.  Returns the port's results."""
    case = 5 + ring  # the seed of _attention_case
    names = MEM_NAMES if ring else WINDOW_NAMES
    fast = mode == "fast"
    if fast and dtype == "bfloat16":
        # exact products, the same 8-bit masks: what the int8 dphi moves
        set_env(monkeypatch, lever_env, {"COMMU_DROPOUT_BITS": "8"})
        exact = run_jax(case, dtype, ring)[1]
    if affected and dtype == "bfloat16":
        set_env(monkeypatch, MODES[mode])
        plain = run_jax(case, dtype, ring)[1]
    set_env(monkeypatch, MODES[mode], lever_env)
    (ref_out, ref), (out, grads) = run_both(case, dtype, ring)
    _close(out, ref_out, dtype, "forward", ties=0.01 if fast else 0.0)
    for i, (grad, r, name) in enumerate(zip(grads, ref, names)):
        if ring and RING[0] == 0 and name in ("dWk", "dWv"):
            continue
        extra = 0.0
        if fast and dtype == "bfloat16":
            extra = _int8_noise(r, exact[i], dtype, name)
        if name in affected and dtype == "bfloat16":
            extra += 2.0 * float(np.abs(_np(r) - _np(plain[i])).max())
        _close(grad, r, dtype, name,
               ties=0.01 if fast or name in affected else 0.0, extra=extra)
    return out, grads


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("lever", sorted(FORWARD) + ["none"])
def test_softmax_phase_follows_the_reference(monkeypatch, lever, p):
    """``softmax_plain`` against the reference's ``_attn_softmax`` on one
    score plane, with its keep mask from the same seed: the P v operand
    before its rounding and the output columns' scale, to an ulp of exp
    (and subnormals).
    The plane has a row past the clamp (scores 70, 65, 61) and a row 500
    below the rest, so clamp, defer and hoist each give another operand
    than the default does."""
    rng = np.random.default_rng(8)
    t, k_len, b, h, seed = 8, 256, 1, 3, 77
    s = (rng.normal(size=(t, k_len)) * 10.0).astype(np.float32)
    s[0, :3] = (70.0, 65.0, 61.0)
    s[1] -= 500.0
    set_env(monkeypatch, FORWARD.get(lever, {}))
    ref, _, ref_col = jfa._attn_softmax(
        jnp.asarray([seed], jnp.int32), jnp.asarray(s), b, h, t=t,
        k_len=k_len, dropout_p=p, train=p > 0.0)
    keep, keep_scale = None, 1.0
    if p:
        keep = prng.keep_mask(seed + b * 4096 + h, (t, k_len), p)
        keep_scale = torch.tensor(prng.keep_scale_for(p), dtype=torch.float32)
    lv = tfa.levers()
    operand, col, _, _ = tfa.softmax_plain(torch.from_numpy(s), keep,
                                           keep_scale, lv)
    # atol: XLA flushes subnormal exps to zero, torch keeps them
    np.testing.assert_allclose(operand.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-37)
    assert (col is None) == (ref_col is None)
    if col is not None:
        np.testing.assert_allclose(np.asarray(col, np.float32),
                                   np.asarray(ref_col, np.float32), rtol=1e-6)
    default, _, _, _ = tfa.softmax_plain(torch.from_numpy(s), keep,
                                         keep_scale)
    changed = lever in ("clamp", "defer") or (lever == "hoist" and p > 0.0)
    assert changed != bool(torch.allclose(operand, default, rtol=1e-3)), lever
    if lever == "clamp":  # the underflowing row: zeros, not NaN
        assert float(operand[1].abs().max()) == 0.0


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "window"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("lever", sorted(FORWARD))
def test_forward_lever_matches_jax(monkeypatch, lever, mode, dtype, ring):
    """The forward and every gradient under one forward lever, at dropout
    0.1 from one seed on both sides."""
    hold(monkeypatch, FORWARD[lever], mode, dtype, ring)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lever", sorted(FORWARD))
def test_projecting_forward_lever_matches_jax(monkeypatch, lever, dtype):
    """#6 (``COMMU_PROJ_IN_FWD=1``, which has no int8 form: exact mode)."""
    hold(monkeypatch, {**FORWARD[lever], "COMMU_PROJ_IN_FWD": "1"}, "exact",
         dtype, True)


@pytest.mark.parametrize("lever", sorted(FORWARD))
def test_eval_forward_honours_the_lever(monkeypatch, lever):
    """Without autograd (an eval window, no dropout) the port's forward is
    the lever's on both sides; clamp changes it, and defer and hoist only
    move roundings (hoist acts under dropout alone)."""
    case = _attention_case("float32", 9)
    (q, k_win, v_win), wk, wv, r_kernel, rwb, rrb, mem, _ = case
    count, head, same_length = RING

    def ours():
        with torch.no_grad():
            return tfa.attention_mem(
                _tt(q, "float32"), _tt(mem, "float32"), 1, _tt(wk, "float32"),
                _tt(wv, "float32"), _tt(k_win, "float32"),
                _tt(v_win, "float32"),
                tfa.pack_r_kernel(_tt(r_kernel, "float32"), HEADS),
                tfa.ring_psi(tfa.key_trig_basis(M + T, 32, torch.float32), T,
                             count, head),
                _tt(rwb, "float32"), _tt(rrb, "float32"), count, head, None,
                d_model=32, scale=0.25, same_length=same_length)

    def theirs():
        psi = jfa.ring_psi(jfa.key_trig_basis(M + T, 32, jnp.float32), T,
                           jnp.int32(count), jnp.int32(head))
        return jfa.attention_mem(
            _jx(q, "float32"), _jx(mem, "float32"), 1, _jx(wk, "float32"),
            _jx(wv, "float32"), _jx(k_win, "float32"), _jx(v_win, "float32"),
            jfa.pack_r_kernel(_jx(r_kernel, "float32"), HEADS), psi,
            _jx(rwb, "float32"), _jx(rrb, "float32"), jnp.int32(count),
            jnp.int32(head), None, d_model=32, scale=0.25,
            same_length=same_length)

    set_env(monkeypatch)
    default = ours()
    set_env(monkeypatch, FORWARD[lever])
    out = ours()
    _close(out, theirs(), "float32", "eval forward")
    if lever == "hoist":
        assert torch.equal(out, default)


def test_clamp_gives_finite_zeros_where_a_row_underflows(monkeypatch):
    """Scores 500 below any other (every exp underflows f32): the clamped
    softmax gives zeros and no NaN, forward and backward, as the reference's
    guard does (``tests/test_fused_attention.py:235``); the max-subtracting
    default gives the shifted softmax."""
    rng = np.random.default_rng(7)
    b, h, dh, t, d_model = 2, 2, 8, 8, 16
    q, k, v, dout = (torch.from_numpy(rng.normal(size=(b, h, dh, t))
                                      .astype(np.float32)) for _ in range(4))
    w_r = tfa.pack_r_kernel(torch.from_numpy(
        rng.normal(size=(d_model, d_model)).astype(np.float32) * 0.2), h)
    rwbs, rrbs = tfa._scaled_biases(torch.zeros(h, dh), torch.zeros(h, dh),
                                    0.35, torch.float32)
    trig_a = tfa.query_trig_table(t, 0, d_model, torch.float32)
    psi = tfa.key_trig_basis(t, d_model, torch.float32)
    mask = torch.full((2, t, t), -500.0, dtype=torch.bfloat16)
    reset = torch.zeros(b, dtype=torch.int32)
    args = (q, rwbs, rrbs, k, v, w_r, trig_a, psi, mask, reset, 0.35)
    clamp = tfa.Levers(clamp=True)
    out, s_res, lse = tfa.rel_attention_fwd_plain(*args, save=True,
                                                  levers=clamp)
    assert torch.isfinite(lse).all() and float(s_res.max()) < -400.0
    assert float(out.abs().max()) == 0.0
    grads = tfa.rel_attention_bwd_plain(*args[:8], s_res, lse, out, dout,
                                        0.35, levers=clamp)
    assert all(torch.isfinite(g).all() for g in grads)
    assert float(grads[2].abs().max()) == 0.0  # dv: P is all zeros
    shifted = tfa.rel_attention_fwd_plain(*args)
    assert float(shifted.abs().max()) > 0.0

    # the reference's softmax phase on the same kind of rows
    s = jnp.asarray(rng.normal(size=(8, 16)) * 10.0 - 500.0, jnp.float32)
    monkeypatch.setenv("COMMU_SOFTMAX", "clamp")
    operand, _, _ = jfa._attn_softmax(None, s, 0, 0, t=8, k_len=16,
                                      dropout_p=0.0, train=False)
    ref = np.asarray(operand)
    assert np.isfinite(ref).all() and np.abs(ref).max() == 0.0


@pytest.mark.parametrize("top", [0.75, 3.0e-4])
def test_rows_and_columns_quantise_as_the_reference(top):
    """``quantize_rows`` is ``_quant_rows`` bit for bit (values and scales,
    rounding ties, an all-zero row); ``quantize_cols`` is the int8 dk's
    column quantiser (``_bwd_stage_b`` :965-967) bit for bit."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(size=(5, 48)).astype(np.float32) * top,
                        _tie_rows(rng, 4, 48, top),
                        np.zeros((1, 48), np.float32)])
    ref_q, ref_sc = jfa._quant_rows(jnp.asarray(x))
    x_q, sc = tfa.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(x_q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(ref_sc))
    assert int(x_q[-1].abs().max()) == 0

    ds = jnp.asarray(x.T)  # [T, K]: a column quantiser over the rows
    cmax = jnp.max(jnp.abs(ds), axis=0, keepdims=True)
    scol = jnp.maximum(cmax, 1e-30) * (1.0 / 127.0)
    ref_qc = jnp.round(ds * (1.0 / scol)).astype(jnp.int8)
    ds_qc, sc_c = tfa.quantize_cols(torch.from_numpy(np.array(ds)))
    np.testing.assert_array_equal(ds_qc.numpy(), np.asarray(ref_qc))
    np.testing.assert_array_equal(sc_c.numpy(), np.asarray(scol))


def test_int8_products_scale_back_as_bwd_stage_b():
    """dk = float(int32 qw_q ds_qc) * sqw * scol and dq = float(int32 kw_q
    dsu_q^T) * (skw * scale) * sdsu, bit for bit against the reference's
    expressions on the same operands."""
    rng = np.random.default_rng(4)
    qw = rng.normal(size=(6, 10)).astype(np.float32)
    ds = (rng.normal(size=(10, 12)) * 1e-3).astype(np.float32)
    kw = rng.normal(size=(6, 20)).astype(np.float32)
    dsu = (rng.normal(size=(10, 20)) * 1e-2).astype(np.float32)
    scale = 0.35

    qw_q, sqw = jfa._quant_rows(jnp.asarray(qw))
    cmax = jnp.max(jnp.abs(jnp.asarray(ds)), axis=0, keepdims=True)
    scol = jnp.maximum(cmax, 1e-30) * (1.0 / 127.0)
    ds_qc = jnp.round(jnp.asarray(ds) * (1.0 / scol)).astype(jnp.int8)
    dk_i = jax.lax.dot_general(qw_q, ds_qc, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    ref_dk = dk_i.astype(jnp.float32) * sqw * scol
    kw_q, skw = jfa._quant_rows(jnp.asarray(kw))
    dsu_q, sdsu = jfa._quant_rows(jnp.asarray(dsu))
    dq_i = jax.lax.dot_general(kw_q, dsu_q, (((1,), (1,)), ((), ())),
                               preferred_element_type=jnp.int32)
    ref_dq = dq_i.astype(jnp.float32) * (skw * scale) * sdsu.reshape(1, -1)

    t_qw_q, t_sqw = tfa.quantize_rows(torch.from_numpy(qw))
    t_ds_qc, t_scol = tfa.quantize_cols(torch.from_numpy(ds))
    dk = tfa._int_matmul(t_qw_q, t_ds_qc) * t_sqw * t_scol
    np.testing.assert_array_equal(dk.numpy(), np.asarray(ref_dk))
    t_kw_q, t_skw = tfa.quantize_rows(torch.from_numpy(kw))
    t_dsu_q, t_sdsu = tfa.quantize_rows(torch.from_numpy(dsu))
    dq = (tfa._int_matmul(t_kw_q, t_dsu_q.t()) * (t_skw * scale)
          * t_sdsu.t())
    np.testing.assert_array_equal(dq.numpy(), np.asarray(ref_dq))


def test_levers_are_read_from_the_environment_at_each_call(monkeypatch):
    """Each lever is on exactly where the reference's reader says so, and
    maps onto the kernels' forms: defer and hoist share the form with the
    keep-scale after P v."""
    set_env(monkeypatch)
    assert tfa.levers() == tfa.NO_LEVERS
    assert tfa.NO_LEVERS.soft == 0 and tfa.NO_LEVERS.int8_grads == 0
    readers = {"COMMU_SOFTMAX": ("clamp", jfa._softmax_clamp),
               "COMMU_DEFER_NORM": ("1", jfa._defer_norm),
               "COMMU_SCALE_HOIST": ("1", jfa._scale_hoist),
               "COMMU_INT8_DQ": ("1", jfa._int8_dq),
               "COMMU_INT8_DK": ("1", jfa._int8_dk)}
    for field, (name, (on, reader)) in zip(tfa.Levers._fields,
                                           readers.items()):
        for value in (on, "0", "max", "true"):
            monkeypatch.setenv(name, value)
            assert getattr(tfa.levers(), field) is reader() is (value == on)
        monkeypatch.delenv(name)
    set_env(monkeypatch, *FORWARD.values(), *INT8.values())
    lv = tfa.levers()
    assert all(lv) and lv.soft == 3 and lv.int8_grads == 3
    assert tfa.Levers(defer=True).soft == tfa.Levers(hoist=True).soft == 2
    assert tfa.Levers(int8_dk=True).int8_grads == 2


def test_lever_forms_have_counts_and_entry_points():
    """Every name a wrapper counts a lever launch under has its count, and
    every lever entry point the library binds is an ``extern "C"`` name of a
    source that ``LEVER_BUILDS`` compiles at that value of COMMU_LEVERS
    (``COMMU_ENTRY(name)``: ``name_levers<n>``)."""
    from commu_tpu_torch.ops import _build

    for kernel in ("rel_attention_fwd", "rel_attention_mem_fwd",
                   "rel_attention_proj_fwd"):
        for code in (1, 2, 3):
            assert tfa._lever_form(kernel, False, (0, 0, 1.0, 16),
                                   code) in _build.LAUNCHES
    for kernel in ("rel_attention_bwd", "rel_attention_mem_bwd"):
        for code in (1, 2, 3):
            assert tfa._lever_form(kernel, True, (0, 26, 1.1, 8), code,
                                   tfa.GRAD_TAGS) in _build.LAUNCHES
    assert tfa._lever_form("rel_attention_fwd", True, (0, 26, 1.1, 8),
                           0) == "rel_attention_fwd[int8]"
    builds = {}
    for src, n in _build.LEVER_BUILDS:
        builds.setdefault(n, []).append(
            (_build.SRC_DIR / src).read_text())
    for name in (*_build._LEVER_SIGNATURES, *_build._LEVER_WORKSPACE):
        base, n = name.rsplit("_levers", 1)
        assert any(f"COMMU_ENTRY({base})" in text
                   for text in builds[int(n)]), name
    assert {n for _, n in _build.LEVER_BUILDS} == {1, 2, 3,
                                                   tfa.BWD_LEVER_BUILD}
