"""The two fused probes and the stacked ring write, against the JAX package
on the CPU.

- ``ring_write`` bit for bit against ``commu_tpu.ops.layout.ring_write`` for
  every slab and two positions of the ring axis;
- ``ffn_block_fused_o`` forward and backward against ``jax.vjp`` of the JAX
  op (Pallas in interpreter mode, jitted), f32 and bf16, dropout 0 and 0.1;
- the whole model with ``COMMU_PROJ_IN_FWD=1`` and ``COMMU_O_IN_FFN=1`` (set
  for both packages with ``monkeypatch.setenv``: each reads its variable at
  every call) against the JAX model's loss and gradients over a full,
  wrapped ring, and against the port's own default path: bit for bit with
  the projection probe (the twin composes the two twins it replaces), and
  to f32 rounding with the o probe (its o = Wo^T vec sums in another order).

f32: rtol 1e-4 and atol 1e-5 of the largest reference magnitude; bf16
(weights of std 0.05): 2e-2 of it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commu_tpu.models.transformer_xl import Memory as JaxMemory
from commu_tpu.ops import layout as jlayout
from commu_tpu.ops.fused_ffn import ffn_block_fused_o as jffn_o
from commu_tpu.ops.fused_nll import fused_token_nll as jax_nll
from commu_tpu.training.step import masked_chunk_loss as jax_chunk_loss
from commu_tpu_torch.models import (memory_from_arrays,
                                    state_dict_from_flax_params)
from commu_tpu_torch.ops import fused_attention as tfa
from commu_tpu_torch.ops import fused_ffn as tffn
from commu_tpu_torch.ops import layout as tlayout
from commu_tpu_torch.ops.fused_nll import fused_token_nll
from commu_tpu_torch.training import masked_chunk_loss

from test_torch_train_ops import TDT, WSTD, _close, _jx, _leaf
from test_torch_train_step import (CFG, _full_ring_case, _jax_state,
                                   _port_model)

PROBES = {"proj": ("COMMU_PROJ_IN_FWD",), "o": ("COMMU_O_IN_FFN",),
          "both": ("COMMU_PROJ_IN_FWD", "COMMU_O_IN_FFN")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,axis", [((3, 4, 2, 6, 5), 1),
                                        ((3, 2, 4, 6, 5), 2)])
def test_ring_write_matches_jax_for_every_slab(shape, axis, dtype):
    rng = np.random.default_rng(axis)
    buf = rng.normal(size=shape).astype(np.float32)
    rows_shape = shape[:axis] + shape[axis + 1:]
    jbuf, tbuf = _jx(buf, dtype), torch.from_numpy(buf).to(TDT[dtype])
    for block in range(shape[axis]):
        rows = rng.normal(size=rows_shape).astype(np.float32)
        jbuf = jlayout.ring_write(jbuf, _jx(rows, dtype), jnp.int32(block),
                                  axis)
        out = tlayout.ring_write(tbuf, torch.from_numpy(rows).to(TDT[dtype]),
                                 block, axis)
        assert out is tbuf  # in place, where the reference returns an alias
        np.testing.assert_array_equal(
            tbuf.float().numpy(), np.asarray(jbuf.astype(jnp.float32)),
            err_msg=f"slab {block}")
    with pytest.raises(ValueError):
        tlayout.ring_write(tbuf, tbuf.select(axis, 0), shape[axis], axis)
    with pytest.raises(ValueError):
        tlayout.ring_write(tbuf, tbuf.select(axis, 0), 0, axis + 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_ffn_block_fused_o_forward_and_backward_match_jax(p, dtype):
    b, d, f, t, hd = 3, 32, 48, 8, 24
    seed = 2 ** 31 - 7 - 8192  # rows 1 and 2 wrap the int32 row-seed sum
    rng = np.random.default_rng(2)
    w = WSTD[dtype]
    arrays = [rng.normal(size=(b, d, t)), rng.normal(size=(b, hd, t)),
              rng.normal(size=(hd, d)) * w, rng.normal(size=(d, f)) * w,
              rng.normal(size=f) * 0.1, rng.normal(size=(f, d)) * w,
              rng.normal(size=d) * 0.1, 1.0 + rng.normal(size=d) * 0.1,
              rng.normal(size=d) * 0.1, 1.0 + rng.normal(size=d) * 0.1,
              rng.normal(size=d) * 0.1]
    dts = [dtype] * 4 + ["float32", dtype] + ["float32"] * 5
    dy = rng.normal(size=(b, d, t))

    @jax.jit
    def run(args, dy):
        out, vjp = jax.vjp(lambda *a: jffn_o(*a, jnp.int32(seed), p, True),
                           *args)
        return out, vjp(dy)

    ref_out, ref = run(tuple(_jx(a, x) for a, x in zip(arrays, dts)),
                       _jx(dy, dtype))
    leaves = [_leaf(a, x) for a, x in zip(arrays, dts)]
    y = tffn.ffn_block_fused_o(*leaves, seed=seed, dropout_p=p, train=True)
    _close(y, ref_out, dtype, "forward")
    y.backward(torch.from_numpy(np.asarray(dy, np.float32)).to(TDT[dtype]))
    names = ("dx", "dvec", "dWo", "dW1", "db1", "dW2", "db2", "dg1", "dbe1",
             "dg2", "dbe2")
    for leaf, r, x, name in zip(leaves, ref, dts, names):
        assert leaf.grad.dtype == TDT[x], name  # the weights come back rounded
        _close(leaf.grad, r, dtype, name)
    with torch.no_grad():  # no residual without autograd, the same values
        again = tffn.ffn_block_fused_o(*leaves, seed=seed, dropout_p=p,
                                       train=True)
    assert again.grad_fn is None and torch.equal(again, y.detach())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_block_fused_o_at_8_bits_matches_jax(dtype, monkeypatch):
    """The fuse_o form's three masks at ``COMMU_DROPOUT_BITS=8`` on both
    sides, at the tolerances of the 16-bit case."""
    monkeypatch.setenv("COMMU_DROPOUT_BITS", "8")
    test_ffn_block_fused_o_forward_and_backward_match_jax(0.1, dtype)


def test_fused_o_equals_the_projection_outside_in_f32():
    """o = Wo^T vec formed inside equals ``ffn_block`` over the projected o,
    up to the order of one f32 sum; in bf16 the unfused o is rounded first,
    and the two differ by that rounding."""
    rng = np.random.default_rng(3)
    b, d, f, t, hd = 2, 32, 48, 5, 32
    x, vec = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for s in ((b, d, t), (b, hd, t)))
    wo = torch.from_numpy((rng.normal(size=(hd, d)) * 0.2).astype(np.float32))
    rest = [torch.from_numpy((rng.normal(size=s) * 0.2).astype(np.float32))
            for s in ((d, f), (f,), (f, d), (d,), (d,), (d,), (d,), (d,))]
    fused = tffn.ffn_block_fused_o(x, vec, wo, *rest)
    outside = tffn.ffn_block(x, torch.matmul(wo.t(), vec), *rest)
    torch.testing.assert_close(fused, outside, rtol=1e-5, atol=1e-5)
    bf = [a.bfloat16() for a in (x, vec, wo)]
    fused16 = tffn.ffn_block_fused_o(*bf, *rest)
    outside16 = tffn.ffn_block(bf[0], torch.matmul(bf[2].t(), bf[1]), *rest)
    assert not torch.equal(fused16, outside16)
    torch.testing.assert_close(fused16.float(), outside16.float(), rtol=2e-2,
                               atol=2e-2)


def _jax_loss_and_grads(jmodel, params, case):
    hidden, count, head, inputs, targets, reset = case

    def loss_fn(p):
        mem = JaxMemory(hidden=jnp.asarray(hidden), count=jnp.int32(count),
                        head=jnp.int32(head), transposed=True)
        out, _ = jmodel.apply({"params": p}, jnp.asarray(inputs), mem,
                              jnp.asarray(reset), deterministic=True,
                              method=jmodel.forward)
        nll = jax_nll(jnp.swapaxes(out, 1, 2), p["embedding"], p["out_bias"],
                      jnp.asarray(targets))
        return jax_chunk_loss(nll, jnp.asarray(targets), 2)[0]
    # a new function each call: the variables are read while it is traced
    return jax.jit(jax.value_and_grad(loss_fn))(params)


def _port_loss_and_grads(model, case):
    hidden, count, head, inputs, targets, reset = case
    model.zero_grad(set_to_none=True)
    out, rows = model.forward_train(
        torch.from_numpy(inputs), torch.from_numpy(reset),
        memory_from_arrays(hidden, count, head))
    nll = fused_token_nll(out.transpose(1, 2), model.embedding,
                          model.out_bias, torch.from_numpy(targets))
    loss = masked_chunk_loss(nll, torch.from_numpy(targets), 2)[0]
    loss.backward()
    return loss.detach(), {name: p.grad.clone()
                           for name, p in model.named_parameters()}, rows


@pytest.mark.parametrize("probe", sorted(PROBES))
def test_probes_match_the_jax_model_and_the_default_path(probe, monkeypatch):
    jmodel, state = _jax_state(CFG)
    case = _full_ring_case()
    model = _port_model(state.params, CFG)
    base_loss, base, base_rows = _port_loss_and_grads(model, case)

    calls = {"proj": 0, "o": 0, "kv": 0}
    for name, fn, key in ((tfa, "rel_attention_proj_fwd", "proj"),
                          (tfa, "project_mem_kv", "kv")):
        def counted(*a, _fn=getattr(name, fn), _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(name, fn, counted)
    fused_o = tffn._FFNBlockFusedO.forward

    def counted_o(*a, **kw):
        calls["o"] += 1
        return fused_o(*a, **kw)
    monkeypatch.setattr(tffn._FFNBlockFusedO, "forward",
                        staticmethod(counted_o))
    for var in PROBES[probe]:
        monkeypatch.setenv(var, "1")

    ref_loss, ref = _jax_loss_and_grads(jmodel, state.params, case)
    ref = state_dict_from_flax_params(
        jax.tree_util.tree_map(np.asarray, ref), CFG.model)
    loss, grads, rows = _port_loss_and_grads(model, case)
    layers = CFG.model.num_layers
    assert calls["proj"] == (layers if probe != "o" else 0)
    assert calls["kv"] == (layers if probe == "o" else 0)
    assert calls["o"] == (layers if probe != "proj" else 0)

    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-4)
    for name, value in grads.items():
        np.testing.assert_allclose(
            value.numpy(), ref[name].numpy(), rtol=1e-4,
            atol=1e-5 * float(ref[name].abs().max()), err_msg=name)
    if probe == "proj":  # the same arithmetic in the same order
        assert torch.equal(loss, base_loss)
        assert all(torch.equal(grads[k], base[k]) for k in base)
        assert all(torch.equal(a, b) for a, b in zip(rows, base_rows))
    else:
        torch.testing.assert_close(loss, base_loss, rtol=1e-5, atol=0)
        for k in base:
            torch.testing.assert_close(
                grads[k], base[k], rtol=1e-4,
                atol=1e-5 * float(base[k].abs().max()), msg=k)


def test_probes_in_eval_and_in_bf16(monkeypatch):
    """The no-grad branch of ``attention_mem`` takes the projecting forward
    too (the eval pass), bit for bit; and in bf16 the o probe stays within a
    rounding of the default path."""
    _, state = _jax_state(CFG)
    hidden, count, head, inputs, _, reset = _full_ring_case()
    for dtype, tol in ((torch.float32, 0.0), (torch.bfloat16, 2e-2)):
        model = _port_model(state.params, CFG)
        model.dtype = dtype
        outs = {}
        for flags in ((), ("COMMU_PROJ_IN_FWD",), ("COMMU_O_IN_FFN",)):
            with monkeypatch.context() as m:
                for var in flags:
                    m.setenv(var, "1")
                with torch.inference_mode():
                    outs[flags], _ = model(
                        torch.from_numpy(inputs), torch.from_numpy(reset),
                        memory=memory_from_arrays(hidden, count, head,
                                                  dtype=dtype))
        assert torch.equal(outs[("COMMU_PROJ_IN_FWD",)], outs[()])
        torch.testing.assert_close(outs[("COMMU_O_IN_FFN",)].float(),
                                   outs[()].float(), rtol=max(tol, 1e-5),
                                   atol=max(tol, 1e-5))


def test_flags_are_read_like_the_reference(monkeypatch):
    from commu_tpu.ops import fused_attention as jfa
    from commu_tpu.ops import fused_ffn as jffn

    for value, want in (("1", True), ("0", False), ("true", False)):
        monkeypatch.setenv("COMMU_PROJ_IN_FWD", value)
        monkeypatch.setenv("COMMU_O_IN_FFN", value)
        assert tfa.proj_in_fwd() is jfa.proj_in_fwd() is want
        assert tffn.o_in_ffn() is jffn.o_in_ffn() is want
    monkeypatch.delenv("COMMU_PROJ_IN_FWD")
    monkeypatch.delenv("COMMU_O_IN_FFN")
    assert not tfa.proj_in_fwd() and not tffn.o_in_ffn()
