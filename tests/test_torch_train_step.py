"""The port's train step against the JAX package's, on the CPU.

The JAX side is ``jax.jit(make_train_step(model, cfg, physical_chunks=1))``
over ``init_train_memory(..., transposed=True)`` with
``attn_impl="pallas"`` (Pallas in interpreter mode); the port's side is
``make_train_step`` over its own ring, from the same weights converted with
``state_dict_from_flax_params``.  At tgt 16 and memory 32 (two slabs) the
ring fills after two steps and wraps after that.  f32 throughout.

At dropout 0.1 the JAX step runs un-jitted with ``jax.random.randint`` and
``jax.random.bernoulli`` wrapped (``record_jax_draws``), and the port's step
is handed the seeds and the psi mask it drew: its own threefry numbers are
not the contract, the step computed from them is.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commu_tpu.config import (EvaluateConfig, ModelConfig, TrainConfig,
                              TrainingConfig)
from commu_tpu.models.transformer_xl import Memory as JaxMemory
from commu_tpu.models.transformer_xl import TransformerXL as JaxTransformerXL
from commu_tpu.models.transformer_xl import logical_memory_view as jax_view
from commu_tpu.ops.fused_nll import fused_token_nll as jax_nll
from commu_tpu.training.step import create_train_state, init_train_memory
from commu_tpu.training.step import make_train_step as jax_make_train_step
from commu_tpu.training.step import masked_chunk_loss as jax_chunk_loss
from commu_tpu.vocab.event_tokens import PAD_ID
from commu_tpu_torch.models import (TransformerXL, init_memory,
                                    logical_memory_view, memory_from_arrays,
                                    state_dict_from_flax_params)
from commu_tpu_torch.training import (make_optimizer, make_train_step,
                                      masked_chunk_loss)
from commu_tpu_torch.training import schedule
from commu_tpu_torch.training.step import step_generator

from test_torch_model import draw_from_record, record_jax_draws
import torch_cpu_threads  # noqa: F401  (one intra-op thread)

VOCAB = 729
B, T, M = 4, 16, 32
CFG = TrainingConfig(
    model=ModelConfig(num_layers=2, num_heads=2, units=32, inner_size=48,
                      dropout=0.0, attention_dropout=0.0, attn_impl="pallas"),
    train=TrainConfig(batch_size=B, batch_chunk=2, tgt_length=T, mem_length=M,
                      lr=4e-3, warmup_step=3),
    evaluate=EvaluateConfig(batch_size=B, tgt_length=T, mem_length=M),
)


def _batches(seed, n):
    """(inputs, targets, reset) per step: PAD targets, and a reset row on
    step 2 so mask row 1 is exercised."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        inputs = rng.randint(1, VOCAB, size=(B, T)).astype(np.int32)
        targets = rng.randint(1, VOCAB, size=(B, T)).astype(np.int32)
        targets[1, -5:] = PAD_ID
        targets[3, -1:] = PAD_ID
        reset = np.zeros(B, dtype=bool)
        reset[2] = i == 2
        out.append((inputs, targets, reset))
    return out


def _jax_state(cfg):
    jmodel = JaxTransformerXL(VOCAB, cfg.model, dtype=jnp.float32)
    state = create_train_state(jax.random.PRNGKey(0), jmodel, cfg)
    return jmodel, state


def _port_model(params, cfg):
    model = TransformerXL(VOCAB, cfg.model, dtype=torch.float32)
    model.load_state_dict(state_dict_from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), cfg.model))
    return model


def _assert_params_close(model, params, cfg, rtol=2e-4, atol=2e-5):
    ref = state_dict_from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), cfg.model)
    ours = model.state_dict()
    for key, value in ref.items():
        np.testing.assert_allclose(ours[key].numpy(), value.numpy(),
                                   rtol=rtol, atol=atol, err_msg=key)


def test_schedule_matches_jax_schedule():
    from commu_tpu.training.schedule import make_lr_schedule

    for warmup in (0, 3, 100):
        tcfg = dataclasses.replace(CFG.train, warmup_step=warmup)
        jsched = make_lr_schedule(tcfg, 2)
        for count in (0, 1, 2, 3, 4, 50, 100, 101, 5000, 200000):
            np.testing.assert_allclose(schedule.lr_at(tcfg, count, 2),
                                       float(jsched(count)), rtol=1e-6,
                                       err_msg=f"warmup {warmup} count {count}")


def test_masked_chunk_loss_matches_jax():
    rng = np.random.default_rng(0)
    nll = rng.random((8, 5)).astype(np.float32)
    targets = rng.integers(0, 4, size=(8, 5)).astype(np.int32)
    targets[2:4] = PAD_ID  # one chunk of 4 chunks is all PAD
    for chunks in (1, 4):
        ref = jax_chunk_loss(jnp.asarray(nll), jnp.asarray(targets), chunks)
        ours = masked_chunk_loss(torch.from_numpy(nll),
                                 torch.from_numpy(targets), chunks)
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


def test_train_steps_match_jax_across_a_wrapping_ring():
    jmodel, state = _jax_state(CFG)
    jstep = jax.jit(jax_make_train_step(jmodel, CFG, physical_chunks=1))
    jmem = init_train_memory(2, B, M, 32, 1, transposed=True, block_len=T)
    model = _port_model(state.params, CFG)
    opt, sched = make_optimizer(model, CFG)
    step = make_train_step(model, opt, sched, CFG)
    tmem = init_memory(2, B, M, 32, block_len=T)
    key = jax.random.PRNGKey(1)
    for i, (inputs, targets, reset) in enumerate(_batches(0, 4)):
        state, jmem, jm = jstep(state, jmem, inputs, targets, reset, key)
        tmem, tm = step(tmem, torch.from_numpy(inputs),
                        torch.from_numpy(targets), torch.from_numpy(reset))
        assert float(tm["token_count"]) == float(jm["token_count"]), i
        for name in ("nll_sum", "grad_norm"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-4, err_msg=f"{name} step {i}")
        assert (tmem.count, tmem.head) == (int(jmem.count), int(jmem.head))
        view = jax_view(JaxMemory(hidden=jmem.hidden[0], count=jmem.count,
                                  head=jmem.head, transposed=True))
        np.testing.assert_allclose(
            logical_memory_view(tmem).numpy()[:, :, M - tmem.count:],
            np.asarray(view)[:, :, M - tmem.count:], rtol=2e-4, atol=2e-5,
            err_msg=f"ring after step {i}")
    assert tmem.count == M and tmem.head == 0  # filled, then wrapped twice
    assert sched.last_epoch == 4
    _assert_params_close(model, state.params, CFG)


def _full_ring_case(seed=5):
    rng = np.random.default_rng(seed)
    hidden = (rng.normal(size=(3, 2, B, 32, T)) * 0.5).astype(np.float32)
    inputs, targets, reset = _batches(seed, 1)[0]
    return hidden, M, 16, inputs, targets, reset


def _jax_grads(jmodel, params, hidden, count, head, inputs, targets, reset):
    def loss_fn(p):
        mem = JaxMemory(hidden=jnp.asarray(hidden), count=jnp.int32(count),
                        head=jnp.int32(head), transposed=True)
        out, _ = jmodel.apply({"params": p}, jnp.asarray(inputs), mem,
                              jnp.asarray(reset), deterministic=True,
                              method=jmodel.forward)
        nll = jax_nll(jnp.swapaxes(out, 1, 2), p["embedding"], p["out_bias"],
                      jnp.asarray(targets))
        return jax_chunk_loss(nll, jnp.asarray(targets), 2)[0]
    return jax.jit(jax.grad(loss_fn))(params)


def _port_grads(model, hidden, count, head, inputs, targets, reset,
                write_first: str = ""):
    """One forward and backward; ``write_first`` writes the window's rows
    into the ring before ``backward()``: "tensor" through the autograd-
    visible in-place copy, "raw" behind autograd's back (as a kernel writing
    through a device pointer does)."""
    model.zero_grad(set_to_none=True)
    memory = memory_from_arrays(hidden, count, head)
    out, rows = model.forward_train(torch.from_numpy(inputs),
                                    torch.from_numpy(reset), memory)
    from commu_tpu_torch.ops.fused_nll import fused_token_nll

    nll = fused_token_nll(out.transpose(1, 2), model.embedding,
                          model.out_bias, torch.from_numpy(targets))
    loss = masked_chunk_loss(nll, torch.from_numpy(targets), 2)[0]
    if write_first == "tensor":
        model.advance_memory(memory, rows)
    elif write_first == "raw":
        with torch.no_grad():
            model.advance_memory(memory.__class__(memory.hidden.data,
                                                  memory.count, memory.head),
                                 rows)
    loss.backward()
    return {name: p.grad.clone() for name, p in model.named_parameters()}


def test_full_ring_gradients_match_jax_and_a_write_before_backward_fails():
    """With a full ring, the slab the window writes holds keys it attended
    to, so the attention backward (dWk/dWv) must see the ring as it was.
    The train step writes after ``backward()``; a write before it either
    trips autograd's version check (the plain path) or, done behind its
    back as a kernel would, changes dWk/dWv away from JAX's."""
    jmodel, state = _jax_state(CFG)
    hidden, count, head, inputs, targets, reset = _full_ring_case()
    ref = state_dict_from_flax_params(jax.tree_util.tree_map(
        np.asarray, _jax_grads(jmodel, state.params, hidden, count, head,
                               inputs, targets, reset)), CFG.model)
    model = _port_model(state.params, CFG)
    grads = _port_grads(model, hidden, count, head, inputs, targets, reset)
    for name, value in grads.items():
        np.testing.assert_allclose(value.numpy(), ref[name].numpy(),
                                   rtol=1e-4,
                                   atol=1e-5 * float(ref[name].abs().max()),
                                   err_msg=name)

    with pytest.raises(RuntimeError, match="inplace"):
        _port_grads(model, hidden, count, head, inputs, targets, reset,
                    write_first="tensor")
    bad = _port_grads(model, hidden, count, head, inputs, targets, reset,
                      write_first="raw")
    qkv = "layers.1.dec_attn.qkv_net.weight"
    hd = CFG.model.units
    assert not np.allclose(bad[qkv][hd:].numpy(), ref[qkv][hd:].numpy(),
                           rtol=1e-4, atol=1e-6)
    # the window's own gradients do not read the ring's overwritten slab
    np.testing.assert_allclose(bad[qkv][:hd].numpy(), grads[qkv][:hd].numpy(),
                               rtol=1e-4, atol=1e-6)


DROP_CFG = CFG.replace(model=dataclasses.replace(
    CFG.model, dropout=0.1, attention_dropout=0.1))


FAST_MODE = {"COMMU_BD_INT8": "1", "COMMU_BD_INT8_BWD": "1",
             "COMMU_DROPOUT_BITS": "8"}


def test_train_steps_with_dropout_match_jax_from_the_recorded_draws(
        monkeypatch):
    """Four steps at dropout 0.1 over the filling, then wrapping ring: same
    tolerances as the dropout-0 case."""
    for name in FAST_MODE:
        monkeypatch.delenv(name, raising=False)
    _dropout_steps(monkeypatch)


def test_train_steps_in_the_fast_mode_match_jax_from_the_recorded_draws(
        monkeypatch):
    """The same four steps with the reference's three levers set on both
    sides (int8 BD forward, int8 dphi backward, 8-bit draws), as the
    training entry points run: same tolerances again.  The un-jitted JAX
    step reads the variables at every call, the port at every op."""
    for name, value in FAST_MODE.items():
        monkeypatch.setenv(name, value)
    _dropout_steps(monkeypatch)


def _dropout_steps(monkeypatch):
    jmodel, state = _jax_state(DROP_CFG)
    jstep = jax_make_train_step(jmodel, DROP_CFG, physical_chunks=1)
    jmem = init_train_memory(2, B, M, 32, 1, transposed=True, block_len=T)
    model = _port_model(state.params, DROP_CFG)
    opt, sched = make_optimizer(model, DROP_CFG)
    drawn = record_jax_draws(monkeypatch)
    asked = []

    def draw(step, k_len, device):
        asked.append((step, k_len))
        return draw_from_record(drawn)

    step = make_train_step(model, opt, sched, DROP_CFG, draw=draw)
    tmem = init_memory(2, B, M, 32, block_len=T)
    key = jax.random.PRNGKey(1)
    first_seeds = []
    for i, (inputs, targets, reset) in enumerate(_batches(0, 4)):
        drawn.clear()
        with jax.disable_jit():
            state, jmem, jm = jstep(state, jmem, inputs, targets, reset, key)
        assert [kind for kind, _ in drawn] == ["mask"] + ["seed"] * 6, i
        first_seeds.append(drawn[1][1])
        tmem, tm = step(tmem, torch.from_numpy(inputs),
                        torch.from_numpy(targets), torch.from_numpy(reset))
        assert float(tm["token_count"]) == float(jm["token_count"]), i
        for name in ("nll_sum", "grad_norm"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-4, err_msg=f"{name} step {i}")
        view = jax_view(JaxMemory(hidden=jmem.hidden[0], count=jmem.count,
                                  head=jmem.head, transposed=True))
        np.testing.assert_allclose(
            logical_memory_view(tmem).numpy()[:, :, M - tmem.count:],
            np.asarray(view)[:, :, M - tmem.count:], rtol=2e-4, atol=2e-5,
            err_msg=f"ring after step {i}")
    assert asked == [(i, M + T) for i in range(4)]
    assert len(set(first_seeds)) == 4  # the JAX stream moves with the step
    # the ring's first rows are the hiddens after the embedding dropout
    assert float((tmem.hidden[0] == 0).float().mean()) > 0.05
    _assert_params_close(model, state.params, DROP_CFG)


def test_default_draw_follows_the_seed_and_the_step():
    """Two runs from one seed take the same steps; the draw of a step is a
    function of (seed, step) alone, so a resumed run continues the stream."""
    def run(seed, steps):
        cfg = DROP_CFG.replace(train=dataclasses.replace(DROP_CFG.train,
                                                         seed=seed))
        model = TransformerXL(VOCAB, cfg.model)
        model.init_parameters(torch.Generator().manual_seed(0))
        opt, sched = make_optimizer(model, cfg)
        step = make_train_step(model, opt, sched, cfg)
        mem = init_memory(2, B, M, 32, block_len=T)
        norms = []
        for inputs, targets, reset in _batches(0, steps):
            mem, metrics = step(mem, torch.from_numpy(inputs),
                                torch.from_numpy(targets),
                                torch.from_numpy(reset))
            norms.append(float(metrics["grad_norm"]))
        return norms

    a, b, c = run(11, 3), run(11, 3), run(12, 3)
    assert a == b and a != c and all(math.isfinite(x) for x in a)
    seeds = {(s, i): step_generator(s, i).initial_seed()
             for s in (11, 12) for i in range(3)}
    assert len(set(seeds.values())) == 6
    assert step_generator(11, 2).initial_seed() == seeds[(11, 2)]


def test_train_step_builds_at_dropout_and_refuses_mem_capacity_0():
    """The step builds at dropout 0.1.  It used to refuse training with no
    XL memory; with the no-memory attention backward it takes that step:
    finite metrics, and the memory it returns still has capacity 0."""
    cfg = CFG.replace(model=dataclasses.replace(CFG.model, dropout=0.1))
    model = TransformerXL(VOCAB, cfg.model)
    model.init_parameters(torch.Generator().manual_seed(0))
    opt, sched = make_optimizer(model, cfg)
    step = make_train_step(model, opt, sched, cfg)
    assert math.isclose(opt.param_groups[0]["lr"], 0.0)  # warmup: lr(0) = 0
    inputs, targets, reset = _batches(0, 1)[0]
    memory, metrics = step(
        init_memory(2, B, 0, 32, block_len=T), torch.from_numpy(inputs),
        torch.from_numpy(targets), torch.from_numpy(reset))
    assert memory.hidden.numel() == 0 and (memory.count, memory.head) == (0, 0)
    assert all(math.isfinite(float(v)) for v in metrics.values())
    assert float(metrics["grad_norm"]) > 0.0 and sched.last_epoch == 1


# collected under its earlier name too, from when the step refused dropout
test_train_step_refuses_dropout = (
    test_train_step_builds_at_dropout_and_refuses_mem_capacity_0)
