"""The port's attention at Transformer-XL's published widths, past
``ModelConfig()``'s dh 50 and 2F 512, against the JAX package on the CPU.

Two widths: units 768 with 12 heads (dh 64, 2F 768) and units 1024 with 8
heads (dh 128, 2F 1024: enwik8-large's).  The same seeded numpy inputs go
through ``commu_tpu``'s ``attention_mem`` and ``attention`` (their Pallas
kernels in interpret mode, under ``jax.vjp``) and the port's (the plain
twins of its kernels, under autograd), in the exact mode and in the fast
mode (the int8 BD forward, the int8 dphi backward, 8-bit masks at dropout
0.1 from one seed).  Tolerances: f32 rtol 1e-5 and atol 1e-5 of the largest
reference magnitude; bf16 2e-2 and 2e-2 (``test_torch_numerics_modes.py``'s);
the fast mode's int8 rounding ties as that file allows them.  The kernels
themselves are held against these twins at the same widths on the card
(``test_torch_kernels_cuda.py``, ``-k wide_widths``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commu_tpu.ops import fused_attention as jfa
from commu_tpu_torch.ops import fused_attention as tfa

T, R, B, L1 = 8, 2, 2, 3
M = R * T
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}
WSTD = {"float32": 0.05, "bfloat16": 0.05}
FAST = {"COMMU_BD_INT8": "1", "COMMU_BD_INT8_BWD": "1",
        "COMMU_DROPOUT_BITS": "8"}
EXACT = {"COMMU_BD_INT8": "0", "COMMU_BD_INT8_BWD": "0",
         "COMMU_DROPOUT_BITS": "16"}
WIDTHS = [(768, 12), (1024, 8)]
# what the int8 products reach: the forward and the position gradients
POSITION = ("dq", "dW_r", "d r_r_bias")


def _jx(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32)).astype(JDT[dtype])


def _tt(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(ours, ref, dtype, name, ties=0.0, extra=0.0):
    """rtol, and atol as a fraction of the largest reference magnitude plus
    ``extra``; ``ties``: the share of elements that may miss it (an int8
    form's rounding ties)."""
    rtol, frac = TOL[dtype]
    ours, ref = _np(ours), _np(ref)
    assert ours.shape == ref.shape, name
    bound = rtol * np.abs(ref) + frac * float(np.abs(ref).max()) + extra
    missed = float((np.abs(ours - ref) > bound).mean())
    assert missed <= ties, (name, missed, float(np.abs(ours - ref).max()))


def _case(d_model, heads, dtype, seed):
    rng = np.random.default_rng(seed)
    dh, w = d_model // heads, WSTD[dtype]
    acts = [rng.normal(size=(B, heads, dh, T)) for _ in range(3)]
    wk, wv = (rng.normal(size=(d_model, heads, dh)) * w for _ in range(2))
    r_kernel = rng.normal(size=(d_model, d_model)) * w
    rwb, rrb = (rng.normal(size=(heads, dh)) * 0.1 for _ in range(2))
    mem = rng.normal(size=(L1, R, B, d_model, T))
    g = rng.normal(size=(B, heads, dh, T))
    return acts, wk, wv, r_kernel, rwb, rrb, mem, g


def _jax(case, d_model, heads, dtype, memory, p, seed):
    """(out, grads) of the JAX package's attention (over the ring when
    ``memory``) under the current environment, in a fresh jit: the modes
    are read while tracing."""
    (q, k_win, v_win), wk, wv, r_kernel, rwb, rrb, mem, g = case
    jdt, dh = JDT[dtype], d_model // heads
    reset = jnp.asarray(np.array([False, True]))
    w_r = jfa.pack_r_kernel(_jx(r_kernel, dtype), heads)
    kw = dict(d_model=d_model, scale=1.0 / dh ** 0.5, same_length=True,
              dropout_p=p, dropout_seed=jnp.int32(seed), train=True)
    if memory:
        psi = jfa.ring_psi(jfa.key_trig_basis(M + T, d_model, jdt), T,
                           jnp.int32(M), jnp.int32(4))
        args = (_jx(q, dtype), _jx(wk, dtype), _jx(wv, dtype),
                _jx(k_win, dtype), _jx(v_win, dtype), w_r,
                _jx(rwb, "float32"), _jx(rrb, "float32"))

        def f(mem, q, wk3, wv3, k_win, v_win, w_r, rwb, rrb):
            return jfa.attention_mem(q, mem, 1, wk3, wv3, k_win, v_win, w_r,
                                     psi, rwb, rrb, jnp.int32(M),
                                     jnp.int32(4), reset, **kw)
    else:
        psi = jfa.key_trig_basis(T, d_model, jdt)
        args = (_jx(q, dtype), _jx(k_win, dtype), _jx(v_win, dtype), w_r,
                _jx(rwb, "float32"), _jx(rrb, "float32"))

        def f(mem, q, k_win, v_win, w_r, rwb, rrb):
            return jfa.attention(q, k_win, v_win, w_r, psi, rwb, rrb, reset,
                                 **kw)

    def run(args, mem, g):
        out, vjp = jax.vjp(lambda *a: f(mem, *a), *args)
        return out, vjp(g)
    return jax.jit(run)(args, _jx(mem, dtype), _jx(g, dtype))


def _port(case, d_model, heads, dtype, memory, p, seed):
    (q, k_win, v_win), wk, wv, r_kernel, rwb, rrb, mem, g = case
    dh = d_model // heads

    def leaf(a, dt=dtype):
        return _tt(a, dt).requires_grad_(True)

    w_r = tfa.pack_r_kernel(_tt(r_kernel, dtype), heads).detach() \
        .requires_grad_(True)
    reset = torch.from_numpy(np.array([False, True]))
    kw = dict(d_model=d_model, scale=1.0 / dh ** 0.5, same_length=True,
              dropout_p=p, dropout_seed=seed, train=True)
    if memory:
        leaves = [leaf(q), leaf(wk), leaf(wv), leaf(k_win), leaf(v_win), w_r,
                  leaf(rwb, "float32"), leaf(rrb, "float32")]
        psi = tfa.ring_psi(tfa.key_trig_basis(M + T, d_model, TDT[dtype]),
                           T, M, 4)
        out = tfa.attention_mem(leaves[0], _tt(mem, dtype), 1, *leaves[1:6],
                                psi, leaves[6], leaves[7], M, 4, reset, **kw)
    else:
        leaves = [leaf(q), leaf(k_win), leaf(v_win), w_r,
                  leaf(rwb, "float32"), leaf(rrb, "float32")]
        out = tfa.attention(*leaves[:4],
                            tfa.key_trig_basis(T, d_model, TDT[dtype]),
                            leaves[4], leaves[5], reset, **kw)
    out.backward(_tt(g, dtype))
    return out, [x.grad for x in leaves]


def _setenv(monkeypatch, env):
    for name, value in env.items():
        monkeypatch.setenv(name, value)


@pytest.mark.parametrize("memory", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d_model,heads", WIDTHS)
def test_attention_at_the_wide_widths_matches_jax(monkeypatch, d_model, heads,
                                                  dtype, memory):
    """The forward and every gradient, over the ring (a wrapped one, a
    reset row) and over the window alone, exact at dropout 0, then the fast
    mode at dropout 0.1."""
    names = (("dq", "dWk", "dWv", "dk_win", "dv_win", "dW_r", "d r_w_bias",
              "d r_r_bias") if memory else
             ("dq", "dk", "dv", "dW_r", "d r_w_bias", "d r_r_bias"))
    case = _case(d_model, heads, dtype, d_model + int(memory))
    _setenv(monkeypatch, EXACT)
    ref_out, ref = _jax(case, d_model, heads, dtype, memory, 0.0, 0)
    out, grads = _port(case, d_model, heads, dtype, memory, 0.0, 0)
    _close(out, ref_out, dtype, "forward")
    for grad, r, name in zip(grads, ref, names):
        _close(grad, r, dtype, name)

    p, seed = 0.1, 2 ** 31 - 1 - 4096
    _setenv(monkeypatch, {"COMMU_DROPOUT_BITS": "8"})
    exact_out, exact = _port(case, d_model, heads, dtype, memory, p, seed)
    _setenv(monkeypatch, FAST)
    ref_out, ref = _jax(case, d_model, heads, dtype, memory, p, seed)
    out, grads = _port(case, d_model, heads, dtype, memory, p, seed)
    assert float((out - exact_out).abs().max()) > 0.0  # int8 products ran
    _close(out, ref_out, dtype, "fast forward", ties=0.01)
    for grad, r, e, name in zip(grads, ref, exact, names):
        # bf16: the two sides' ds differ by bf16 roundings, so their
        # quantised copies differ beyond ties (test_torch_numerics_modes.py):
        # twice the distance the int8 dphi moves the port's own gradient
        extra = 2.0 * float((grad - e).abs().max()) \
            if dtype == "bfloat16" and name in POSITION else 0.0
        _close(grad, r, dtype, f"fast {name}", ties=0.01, extra=extra)
