"""Training without XL memory (``train.mem_length=0``): the port against the
JAX package, on the CPU.

- the whole model's gradients against ``jax.grad`` through
  ``TransformerXL.apply`` over ``init_memory(L, B, 0, D)`` (the no-memory
  attention, Pallas in interpreter mode, with its own backward);
- the train step against step 0 of the JAX ``make_train_step`` over a dense
  zero-capacity ``TrainMemory``, and three more steps of the port alone;
- ``Trainer.train`` and the CLI at ``train.mem_length=0``.

f32 throughout: metrics to rtol 1e-4, parameters and gradients as
``tests/test_torch_train_step.py`` holds them.  (In bf16 one ReLU gate that
flips between the two implementations moves a whole row of a weight
gradient; the ops are held against ``jax.vjp`` in bf16 one by one, in
``tests/test_torch_attention_bwd.py`` and ``tests/test_torch_train_ops.py``.)
"""
import dataclasses
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commu_tpu.models.transformer_xl import TransformerXL as JaxTransformerXL
from commu_tpu.models.transformer_xl import init_memory as jax_init_memory
from commu_tpu.ops.fused_nll import fused_token_nll as jax_nll
from commu_tpu.training.step import init_train_memory
from commu_tpu.training.step import make_train_step as jax_make_train_step
from commu_tpu.training.step import masked_chunk_loss as jax_chunk_loss
from commu_tpu_torch.models import (TransformerXL, init_memory,
                                    memory_capacity,
                                    state_dict_from_flax_params)
from commu_tpu_torch.ops.fused_nll import fused_token_nll
from commu_tpu_torch.training import (make_optimizer, make_train_step,
                                      masked_chunk_loss)

from test_torch_model import random_params
from test_torch_train_step import (B, CFG, T, VOCAB, _assert_params_close,
                                   _batches, _jax_state, _port_model)
import torch_cpu_threads  # noqa: F401  (one intra-op thread)

CFG0 = CFG.replace(train=dataclasses.replace(CFG.train, mem_length=0))
L, D = CFG.model.num_layers, CFG.model.units


def _jax_grads(jmodel, params, inputs, targets, reset, same_length, dtype):
    def loss_fn(p):
        mem = jax_init_memory(L, B, 0, D, dtype=dtype)
        out, _ = jmodel.apply({"params": p}, jnp.asarray(inputs), mem,
                              jnp.asarray(reset), same_length=same_length,
                              deterministic=True, method=jmodel.forward)
        nll = jax_nll(jnp.swapaxes(out, 1, 2), p["embedding"], p["out_bias"],
                      jnp.asarray(targets))
        return jax_chunk_loss(nll, jnp.asarray(targets), 2)[0]
    return jax.jit(jax.value_and_grad(loss_fn))(params)


@pytest.mark.parametrize("same_length", [False, True])
def test_model_gradients_match_jax_without_memory(same_length):
    jdt, tdt = jnp.float32, torch.float32
    params = random_params(CFG.model, VOCAB, seed=11)
    inputs, targets, reset = _batches(3, 1)[0]
    reset[1] = True
    jmodel = JaxTransformerXL(VOCAB, CFG.model, dtype=jdt)
    ref_loss, ref = _jax_grads(
        jmodel, jax.tree_util.tree_map(jnp.asarray, params), inputs, targets,
        reset, same_length, jdt)
    ref = state_dict_from_flax_params(
        jax.tree_util.tree_map(np.asarray, ref), CFG.model)

    model = TransformerXL(VOCAB, CFG.model, dtype=tdt)
    model.load_state_dict(state_dict_from_flax_params(params, CFG.model))
    memory = init_memory(L, B, 0, D, dtype=tdt, block_len=T)
    out, rows = model.forward_train(torch.from_numpy(inputs),
                                    torch.from_numpy(reset), memory,
                                    same_length=same_length)
    nll = fused_token_nll(out.transpose(1, 2), model.embedding,
                          model.out_bias, torch.from_numpy(targets))
    loss = masked_chunk_loss(nll, torch.from_numpy(targets), 2)[0]
    loss.backward()
    rtol, frac = 1e-4, 1e-5
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=rtol)
    assert len(rows) == L + 1 and rows[0].shape == (B, D, T)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), ref[name].numpy(), rtol=rtol,
            atol=frac * float(ref[name].abs().max()), err_msg=name)
    # the same forward with no Memory at all takes the same path
    plain = model(torch.from_numpy(inputs), torch.from_numpy(reset),
                  same_length=same_length)
    assert torch.equal(plain.detach(), out.detach())


def test_train_step_matches_jax_step_0_and_the_memory_stays_empty():
    """Step 0 of the JAX step over a dense zero-capacity ``TrainMemory``
    (``transposed=False``: its blocked form asserts), then three more steps
    of the port.

    The JAX step's later steps are no reference.  Its dense branch keeps
    ``stacked[..., -m_cap:, :]``, and with ``m_cap`` 0 that slice is the
    whole window: the memory it returns has capacity T, so its step 1
    attends over a memory that ``mem_length=0`` says does not exist (the
    model's own ``_update_memory`` guards the case; the step does not).  The
    port keeps the memory at capacity 0, as the original trainer's
    ``mem_len=0`` does, so every one of its steps is a step 0: it is held to
    finite metrics, an unchanged empty memory and a loss that falls."""
    jmodel, state = _jax_state(CFG0)
    jstep = jax.jit(jax_make_train_step(jmodel, CFG0, physical_chunks=1))
    jmem = init_train_memory(L, B, 0, D, 1, transposed=False)
    model = _port_model(state.params, CFG0)
    opt, sched = make_optimizer(model, CFG0)
    step = make_train_step(model, opt, sched, CFG0)
    tmem = init_memory(L, B, 0, D, block_len=T)
    batches = _batches(0, 4)

    inputs, targets, reset = batches[0]
    state, jmem, jm = jstep(state, jmem, inputs, targets, reset,
                            jax.random.PRNGKey(1))
    tmem, tm = step(tmem, *(torch.from_numpy(x) for x in batches[0]))
    assert float(tm["token_count"]) == float(jm["token_count"])
    for name in ("nll_sum", "grad_norm"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-4, err_msg=name)
    # lr(0) is 0 under warmup: the parameters agree because neither moved
    _assert_params_close(model, state.params, CFG0)
    # the fault this test does not copy: the JAX memory grew to capacity T
    assert jmem.hidden.shape[3] == T
    assert memory_capacity(tmem) == 0

    losses = [float(tm["nll_sum"]) / float(tm["token_count"])]
    for batch in batches[1:] + batches:
        tmem, tm = step(tmem, *(torch.from_numpy(x) for x in batch))
        assert memory_capacity(tmem) == 0 and tmem.hidden.numel() == 0
        assert (tmem.count, tmem.head) == (0, 0)
        assert all(math.isfinite(float(v)) for v in tm.values())
        losses.append(float(tm["nll_sum"]) / float(tm["token_count"]))
    assert sched.last_epoch == 8
    assert losses[-1] < losses[0]  # the second pass over the same batches


def test_fast_mode_step_0_at_capacity_0_matches_jax(monkeypatch):
    """Step 0 without XL memory at dropout 0.1 with the reference's three
    levers set on both sides (``attention``'s int8 BD forward and int8 dphi
    backward, 8-bit draws): the un-jitted JAX step with its draws recorded
    against the port's step handed the same seeds and psi mask.  Metrics to
    rtol 1e-4; lr(0) is 0, so the parameters agree because neither moved
    (the later JAX steps are no reference, see above)."""
    from test_torch_model import draw_from_record, record_jax_draws
    from test_torch_train_step import FAST_MODE

    for name, value in FAST_MODE.items():
        monkeypatch.setenv(name, value)
    cfg = CFG0.replace(model=dataclasses.replace(
        CFG0.model, dropout=0.1, attention_dropout=0.1))
    jmodel, state = _jax_state(cfg)
    jstep = jax_make_train_step(jmodel, cfg, physical_chunks=1)
    jmem = init_train_memory(L, B, 0, D, 1, transposed=False)
    model = _port_model(state.params, cfg)
    opt, sched = make_optimizer(model, cfg)
    drawn = record_jax_draws(monkeypatch)
    step = make_train_step(model, opt, sched, cfg,
                           draw=lambda *_: draw_from_record(drawn))
    tmem = init_memory(L, B, 0, D, block_len=T)
    batch = _batches(0, 1)[0]
    with jax.disable_jit():
        state, jmem, jm = jstep(state, jmem, *batch, jax.random.PRNGKey(1))
    assert [kind for kind, _ in drawn] == ["mask"] + ["seed"] * 6
    tmem, tm = step(tmem, *(torch.from_numpy(x) for x in batch))
    assert float(tm["token_count"]) == float(jm["token_count"])
    for name in ("nll_sum", "grad_norm"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-4, err_msg=name)
    _assert_params_close(model, state.params, cfg)
    assert memory_capacity(tmem) == 0

    # the exact mode from the same draws takes another step
    for name in FAST_MODE:
        monkeypatch.delenv(name)
    model = _port_model(_jax_state(cfg)[1].params, cfg)
    opt, sched = make_optimizer(model, cfg)
    step = make_train_step(model, opt, sched, cfg,
                           draw=lambda *_: draw_from_record(drawn))
    _, exact = step(init_memory(L, B, 0, D, block_len=T),
                    *(torch.from_numpy(x) for x in batch))
    assert float(exact["nll_sum"]) != float(tm["nll_sum"])


def test_train_step_at_capacity_0_with_dropout_is_seeded():
    """``ModelConfig()``'s kind of step (dropout and attention dropout 0.1)
    at capacity 0: the draw asks for a psi mask of the window's length, two
    runs from one seed take the same steps, and another seed differs."""
    cfg = CFG0.replace(model=dataclasses.replace(
        CFG0.model, dropout=0.1, attention_dropout=0.1))

    def run(seed):
        c = cfg.replace(train=dataclasses.replace(cfg.train, seed=seed))
        model = TransformerXL(VOCAB, c.model)
        model.init_parameters(torch.Generator().manual_seed(0))
        opt, sched = make_optimizer(model, c)
        step = make_train_step(model, opt, sched, c)
        mem = init_memory(L, B, 0, D, block_len=T)
        norms = []
        for batch in _batches(1, 3):
            mem, m = step(mem, *(torch.from_numpy(x) for x in batch))
            norms.append(float(m["grad_norm"]))
        assert memory_capacity(mem) == 0
        return norms

    a, b, c = run(3), run(3), run(4)
    assert a == b and a != c and all(math.isfinite(x) for x in a)


def test_trainer_and_cli_train_at_mem_length_0(tmp_path):
    """``python -m commu_tpu_torch.train --set train.mem_length=0`` (in
    process, small shapes, CPU): steps, an eval at ``evaluate.mem_length=0``,
    both checkpoints and ``final_test``."""
    from commu_tpu_torch import train as train_cli
    from commu_tpu_torch.data.dataset import save_corpus

    rng = np.random.RandomState(0)

    def seqs(n):
        return ([rng.randint(560, 729, size=11).astype(np.int64)
                 for _ in range(n)],
                [rng.randint(2, 560, size=rng.randint(20, 60))
                 .astype(np.int64) for _ in range(n)])

    save_corpus(tmp_path / "npy", "train", *seqs(12))
    save_corpus(tmp_path / "npy", "val", *seqs(5))
    work = train_cli.main([
        "--device", "cpu", "--data_dir", str(tmp_path / "npy"), "--work_dir",
        str(tmp_path / "run"), "--dtype", "float32", "--max_step", "4",
        "--set", "train.mem_length=0", "--set", "evaluate.mem_length=0",
        "--set", "train.batch_size=4", "--set", "train.batch_chunk=2",
        "--set", "train.tgt_length=16", "--set", "evaluate.batch_size=2",
        "--set", "evaluate.tgt_length=16", "--set", "model.num_layers=2",
        "--set", "model.num_heads=2", "--set", "model.units=32",
        "--set", "model.inner_size=48", "--set", "train.log_interval=2",
        "--set", "train.eval_interval=4", "--set", "train.warmup_step=2"])
    log = (tmp_path / "run").glob("*/train.log")
    text = next(log).read_text()
    for needle in ("Train Step 4/4", "Eval step 4", "Test step 4",
                   "End of training | test nll"):
        assert needle in text, needle
    assert "nan" not in text.lower()
    for name in ("checkpoint_last.pt", "checkpoint_best.pt"):
        assert (Path(work) / name).is_file()
