"""The port's no-memory attention, forward and backward, against ``jax.vjp``
of the JAX package's ``fused_attention.attention``, on the CPU.

Inputs and the cotangent come from numpy with a fixed seed and go through
both sides.  The JAX side runs its Pallas kernels in interpreter mode,
jitted (``_fused_fwd`` with the probability checkpoint, then ``_fused_bwd``);
the port's wrappers run their plain twins (CPU tensors) inside its autograd
``Function``: ``rel_attention_fwd_plain`` with the save outputs and
``rel_attention_bwd_plain``.  Every cotangent is compared, the bias
gradients included.  f32: rtol 1e-4 and atol 1e-5 of the largest reference
magnitude; bf16 (weights of std 0.05): 2e-2 of it, a few bf16 rounding flips.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commu_tpu.ops import fused_attention as jfa
from commu_tpu_torch.ops import fused_attention as tfa

from test_torch_train_ops import JDT, TDT, WSTD, _close, _jx, _leaf
import torch_cpu_threads  # noqa: F401  (one intra-op thread)

D_MODEL, HEADS = 32, 2
D_HEAD = D_MODEL // HEADS
B, T = 3, 12
SEED = 2 ** 31 - 1 - 4096  # rows 1 and 2 wrap the int32 sum of the row seeds
NAMES = ("dq", "dk", "dv", "dW_r", "d r_w_bias", "d r_r_bias")


def _case(dtype, seed):
    rng = np.random.default_rng(seed)
    w = WSTD[dtype]
    q, k, v = (rng.normal(size=(B, HEADS, D_HEAD, T)) for _ in range(3))
    r_kernel = rng.normal(size=(D_MODEL, D_MODEL)) * w
    rwb, rrb = (rng.normal(size=(HEADS, D_HEAD)) * 0.1 for _ in range(2))
    g = rng.normal(size=(B, HEADS, D_HEAD, T))
    return q, k, v, r_kernel, rwb, rrb, g


def _jax_reference(case, dtype, same_length, p, reset):
    q, k, v, r_kernel, rwb, rrb, g = case
    psi = jfa.key_trig_basis(T, D_MODEL, JDT[dtype])

    @jax.jit
    def run(args, g):
        out, vjp = jax.vjp(lambda q, k, v, w_r, rwb, rrb: jfa.attention(
            q, k, v, w_r, psi, rwb, rrb, jnp.asarray(reset), d_model=D_MODEL,
            scale=1.0 / D_HEAD ** 0.5, same_length=same_length, dropout_p=p,
            dropout_seed=jnp.int32(SEED), train=True), *args)
        return out, vjp(g)

    return run((_jx(q, dtype), _jx(k, dtype), _jx(v, dtype),
                jfa.pack_r_kernel(_jx(r_kernel, dtype), HEADS),
                _jx(rwb, "float32"), _jx(rrb, "float32")), _jx(g, dtype))


def _port(case, dtype, same_length, p, reset):
    q, k, v, r_kernel, rwb, rrb, g = case
    leaves = [_leaf(q, dtype), _leaf(k, dtype), _leaf(v, dtype),
              tfa.pack_r_kernel(_leaf(r_kernel, dtype), HEADS).detach()
              .requires_grad_(True),
              _leaf(rwb, "float32"), _leaf(rrb, "float32")]
    out = tfa.attention(
        *leaves[:4], tfa.key_trig_basis(T, D_MODEL, TDT[dtype]), *leaves[4:],
        torch.from_numpy(reset), d_model=D_MODEL, scale=1.0 / D_HEAD ** 0.5,
        same_length=same_length, dropout_p=p, dropout_seed=SEED, train=True)
    out.backward(torch.from_numpy(np.asarray(g, np.float32)).to(TDT[dtype]))
    return out, leaves


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("same_length", [False, True])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_attention_forward_and_backward_match_jax(p, same_length, dtype):
    """A reset row, ``same_length`` both ways, and dropout 0 and 0.1 from
    one seed (the port recomputes the mask from the hash where the reference
    reads it off its sign-encoded probabilities)."""
    case = _case(dtype, 7 + int(same_length))
    reset = np.array([False, True, False])
    ref_out, ref = _jax_reference(case, dtype, same_length, p, reset)
    out, leaves = _port(case, dtype, same_length, p, reset)
    _close(out, ref_out, dtype, "forward")
    for leaf, r, name in zip(leaves, ref, NAMES):
        assert leaf.grad.dtype == leaf.dtype, name
        _close(leaf.grad, r, dtype, name)


def test_backward_twin_takes_the_forward_twins_residual():
    """The twins' own contract, which the kernels are held to on the card:
    ``rel_attention_fwd_plain(save=True)`` hands (S, lse) to
    ``rel_attention_bwd_plain``; masked scores carry the mask, a row's
    probabilities exp(S - lse) sum to 1, and the no-memory backward equals
    the memory backward over a ring of capacity 0."""
    q, k, v, r_kernel, rwb, rrb, g = (
        torch.from_numpy(np.asarray(a, np.float32))
        for a in _case("float32", 3))
    scale = 1.0 / D_HEAD ** 0.5
    rwbs, rrbs = tfa._scaled_biases(rwb, rrb, scale, torch.float32)
    w_r = tfa.pack_r_kernel(r_kernel, HEADS)
    trig_a = tfa.query_trig_table(T, 0, D_MODEL, torch.float32)
    psi = tfa.key_trig_basis(T, D_MODEL, torch.float32)
    mask = tfa.build_mask_bias(T, 0, 0, 0, False)
    reset = torch.tensor([0, 1, 0], dtype=torch.int32)
    fwd = (q, rwbs, rrbs, k, v, w_r, trig_a, psi, mask, reset, scale)
    out, s_res, lse = tfa.rel_attention_fwd(*fwd, save=True, seed=5,
                                            dropout_p=0.1)
    assert torch.equal(out, tfa.rel_attention_fwd(*fwd, seed=5,
                                                  dropout_p=0.1))
    assert s_res.shape == (B, HEADS, T, T) and lse.shape == (B, HEADS, T)
    causal = torch.ones(T, T, dtype=torch.bool).tril()
    assert bool((s_res[..., ~causal] < -1e30).all())
    torch.testing.assert_close(torch.exp(s_res - lse[..., None]).sum(-1),
                               torch.ones(B, HEADS, T), rtol=1e-5, atol=1e-5)

    bwd = (q, rwbs, rrbs, k, v, w_r, trig_a, psi, s_res, lse, out, g, scale)
    ours = tfa.rel_attention_bwd(*bwd, seed=5, dropout_p=0.1)
    empty = torch.zeros(B, 0, HEADS, D_HEAD, 0)
    ring = torch.zeros(1, 0, B, D_MODEL, 0)
    mem = tfa.rel_attention_mem_bwd_plain(
        q, rwbs, rrbs, empty, k, empty, v, ring, 0, w_r, trig_a, psi, s_res,
        lse, out, g, scale, seed=5, dropout_p=0.1)
    assert float(mem[3].abs().max()) == 0.0 == float(mem[4].abs().max())
    for a, b in zip(ours, mem[:3] + mem[5:]):
        assert torch.equal(a, b)
