"""The port's unfused attention path (``attn_impl="xla"`` or
``clamp_len > 0``) against the JAX package's XLA path, and against the
port's own kernel path, on the CPU at 2 layers, 32 wide.

Weights are a seeded numpy params tree (``test_torch_model.random_params``)
or the JAX ``create_train_state``'s; both sides read the same numpy inputs.
Also the Gumbel sampler and ``token_nll`` against JAX's, decode's refusal
of ``clamp_len > 0``, the unfused dropout, and the train CLI on this path.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commu_tpu.config import (EvaluateConfig, ModelConfig, TrainConfig,
                              TrainingConfig)
from commu_tpu.models import transformer_xl as jxl
from commu_tpu.training.step import create_train_state
from commu_tpu.training.step import init_train_memory as jax_train_memory
from commu_tpu.training.step import make_eval_step as jax_make_eval_step
from commu_tpu.training.step import make_train_step as jax_make_train_step
from commu_tpu_torch import train as train_cli
from commu_tpu_torch.data.dataset import save_corpus
from commu_tpu_torch.models import (TransformerXL, forward_generate_gumbel,
                                    gumbel_softmax, init_memory,
                                    logical_memory_view, resolve_attn_impl,
                                    state_dict_from_flax_params, token_nll)
from commu_tpu_torch.models import decode
from commu_tpu_torch.models.transformer_xl import plain_dropout
from commu_tpu_torch.training import (Trainer, make_eval_step,
                                      make_optimizer, make_train_step)
from commu_tpu_torch.training.step import (init_train_memory,
                                           resolve_physical_chunks)

from test_torch_model import port_model, random_params
from test_torch_train_step import _batches

VOCAB = 729
B, T, M = 4, 16, 32
MODEL = ModelConfig(num_layers=2, num_heads=2, units=32, inner_size=48,
                    dropout=0.0, attention_dropout=0.0, attn_impl="xla")
CFG = TrainingConfig(
    model=MODEL,
    train=TrainConfig(batch_size=B, batch_chunk=2, tgt_length=T, mem_length=M,
                      lr=4e-3, warmup_step=3),
    evaluate=EvaluateConfig(batch_size=B, tgt_length=T, mem_length=M),
)
TOL = dict(rtol=2e-4, atol=2e-5)  # the f32 model tolerance of the tests


def _port_from_jax(params, cfg):
    model = TransformerXL(VOCAB, cfg, dtype=torch.float32)
    model.load_state_dict(state_dict_from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), cfg))
    return model


def test_resolve_attn_impl_selects_the_unfused_path_as_jax_does():
    for impl, clamp in (("pallas", -1), ("xla", -1), ("pallas", 3),
                        ("xla", 3), ("auto", 3), ("pallas", 0)):
        cfg = dataclasses.replace(MODEL, attn_impl=impl, clamp_len=clamp)
        assert resolve_attn_impl(cfg) == jxl.resolve_attn_impl(cfg), (impl,
                                                                      clamp)
    # "auto" is the kernel path in the port (the JAX package picks XLA off
    # a TPU)
    assert resolve_attn_impl(dataclasses.replace(MODEL, attn_impl="auto")) \
        == "pallas"
    with pytest.raises(ValueError, match="attn_impl"):
        resolve_attn_impl(dataclasses.replace(MODEL, attn_impl="cuda"))
    assert TransformerXL(VOCAB, dataclasses.replace(
        MODEL, attn_impl="auto", clamp_len=8)).attn_impl == "xla"


@pytest.mark.parametrize("clamp_len", [-1, 3])
def test_forward_over_three_windows_matches_jax_xla_path(clamp_len):
    cfg = dataclasses.replace(MODEL, clamp_len=clamp_len)
    params = random_params(cfg, VOCAB, seed=4)
    jmodel = jxl.TransformerXL(VOCAB, cfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    model = port_model(params, cfg, VOCAB)
    rng = np.random.default_rng(clamp_len + 10)
    jmem = jxl.init_memory(cfg.num_layers, 3, 24, cfg.units)
    tmem = init_memory(cfg.num_layers, 3, 24, cfg.units, dense=True)
    for window in range(3):  # count 8, 16, then full (24)
        tokens = rng.integers(1, VOCAB, size=(3, 8)).astype(np.int32)
        reset = np.array([False, window == 1, False])
        out, new_jmem, hids = jmodel.apply(
            {"params": jparams}, jnp.asarray(tokens), jmem, jnp.asarray(reset),
            method=jmodel.forward, return_hiddens=True)
        logits, _ = jmodel.apply({"params": jparams}, jnp.asarray(tokens),
                                 jmem, jnp.asarray(reset))
        jmem = new_jmem
        with torch.inference_mode():
            t_out, tmem, t_hids = model(torch.from_numpy(tokens),
                                        torch.from_numpy(reset), memory=tmem,
                                        return_hiddens=True)
            t_logits = model.logits(t_out)
        np.testing.assert_allclose(t_out.numpy(), np.asarray(out), **TOL)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits),
                                   **TOL)
        for i, (ours, ref) in enumerate(zip(t_hids, hids)):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL,
                                       err_msg=f"hidden {i}")
        assert (tmem.count, tmem.head) == (int(jmem.count), int(jmem.head))
        np.testing.assert_allclose(logical_memory_view(tmem).numpy(),
                                   np.asarray(jxl.logical_memory_view(jmem)),
                                   **TOL)


def test_three_train_steps_in_two_chunks_match_jax():
    jmodel = jxl.TransformerXL(VOCAB, MODEL)
    state = create_train_state(jax.random.PRNGKey(0), jmodel, CFG)
    jstep = jax.jit(jax_make_train_step(jmodel, CFG))
    assert resolve_physical_chunks(CFG) == 2
    jmem = jax_train_memory(2, B, M, 32, 2)
    model = _port_from_jax(state.params, MODEL)
    opt, sched = make_optimizer(model, CFG)
    step = make_train_step(model, opt, sched, CFG)
    tmem = init_train_memory(2, B, M, 32, 2)
    assert tmem.hidden.shape == jmem.hidden.shape == (2, 3, 2, M, 32)
    for i, (inputs, targets, reset) in enumerate(_batches(3, 3)):
        state, jmem, jm = jstep(state, jmem, inputs, targets, reset,
                                jax.random.PRNGKey(1))
        tmem, tm = step(tmem, torch.from_numpy(inputs),
                        torch.from_numpy(targets), torch.from_numpy(reset))
        assert float(tm["token_count"]) == float(jm["token_count"])
        for name in ("nll_sum", "grad_norm"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-4, err_msg=f"{name} step {i}")
        assert tmem.count == int(jmem.count) == min((i + 1) * T, M)
        np.testing.assert_allclose(tmem.hidden.numpy(),
                                   np.asarray(jmem.hidden), **TOL,
                                   err_msg=f"memory after step {i}")
    ref = state_dict_from_flax_params(
        jax.tree_util.tree_map(np.asarray, state.params), MODEL)
    for key, value in ref.items():
        np.testing.assert_allclose(model.state_dict()[key].numpy(),
                                   value.numpy(), **TOL, err_msg=key)


def test_unfused_path_matches_the_kernel_path_across_a_wrapping_ring():
    """The port's two paths from the same weights and batches: the dense
    memory in two physical chunks against the blocked ring in one, over a
    memory that fills and then wraps twice, a reset row on step 3."""
    cfg_p = CFG.replace(model=dataclasses.replace(MODEL, attn_impl="pallas"))
    params = random_params(MODEL, VOCAB, seed=8, weight_std=0.05)
    steps = {}
    for cfg in (CFG, cfg_p):
        model = port_model(params, cfg.model, VOCAB)
        opt, sched = make_optimizer(model, cfg)
        step = make_train_step(model, opt, sched, cfg)
        memory = init_train_memory(2, B, M, 32, 2) \
            if cfg is CFG else init_memory(2, B, M, 32, block_len=T)
        out = []
        for i, (inputs, targets, reset) in enumerate(_batches(5, 5)):
            reset[1] = i == 3
            memory, metrics = step(memory, torch.from_numpy(inputs),
                                   torch.from_numpy(targets),
                                   torch.from_numpy(reset))
            if cfg is CFG:  # the chunks' rows, back in batch order
                view = memory.hidden.transpose(0, 1).reshape(3, B, M, 32)
            else:
                view = logical_memory_view(memory)
            out.append((float(metrics["nll_sum"]),
                        float(metrics["grad_norm"]), memory.count,
                        view.numpy().copy()))
        steps[cfg.model.attn_impl] = out
    for i, (x, p) in enumerate(zip(steps["xla"], steps["pallas"])):
        np.testing.assert_allclose(p[0], x[0], rtol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(p[1], x[1], rtol=1e-4, err_msg=f"step {i}")
        assert p[2] == x[2]
        np.testing.assert_allclose(p[3][:, :, M - p[2]:], x[3][:, :, M - x[2]:],
                                   **TOL, err_msg=f"memory after step {i}")


def test_eval_step_over_three_windows_matches_jax():
    params = random_params(MODEL, VOCAB, seed=6)
    jmodel = jxl.TransformerXL(VOCAB, MODEL)
    jstep = jax.jit(jax_make_eval_step(jmodel, same_length=True))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    model = port_model(params, MODEL, VOCAB)
    step = make_eval_step(model, same_length=True)
    jmem = jxl.init_memory(2, B, M, 32)
    tmem = init_memory(2, B, M, 32, dense=True)
    for i, (inputs, targets, reset) in enumerate(_batches(9, 3)):
        j_nll, j_tok, jmem = jstep(jparams, jmem, inputs, targets, reset)
        t_nll, t_tok, tmem = step(tmem, torch.from_numpy(inputs),
                                  torch.from_numpy(targets),
                                  torch.from_numpy(reset))
        assert float(t_tok) == float(j_tok)
        np.testing.assert_allclose(float(t_nll), float(j_nll), rtol=1e-5,
                                   err_msg=f"window {i}")
        np.testing.assert_allclose(tmem.hidden.numpy(),
                                   np.asarray(jmem.hidden), **TOL)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    rng = np.random.RandomState(1)

    def seqs(n):
        metas = [rng.randint(560, 729, size=11).astype(np.int64)
                 for _ in range(n)]
        events = [rng.randint(2, 560, size=rng.randint(20, 90))
                  .astype(np.int64) for _ in range(n)]
        return metas, events

    d = tmp_path_factory.mktemp("corpus") / "npy"
    save_corpus(d, "train", *seqs(12))
    save_corpus(d, "val", *seqs(5))
    return d


def test_trainer_evaluate_on_both_paths_agrees(corpus):
    """``Trainer.evaluate`` builds the dense memory on the unfused path;
    from the same seeded weights both paths give the same val NLL."""
    totals = {}
    for impl in ("xla", "pallas"):
        cfg = CFG.replace(model=dataclasses.replace(MODEL, attn_impl=impl))
        trainer = Trainer(str(corpus), cfg, device="cpu",
                          model_dtype=torch.float32)
        totals[impl] = trainer.evaluate("valid")
    assert totals["xla"][0] == totals["pallas"][0] > 0
    np.testing.assert_allclose(totals["xla"][1], totals["pallas"][1],
                               rtol=1e-5)


def test_decode_refuses_clamp_len():
    cfg = dataclasses.replace(MODEL, clamp_len=3, same_length=True)
    model = port_model(random_params(cfg, VOCAB), cfg, VOCAB)
    with pytest.raises(NotImplementedError,
                       match="decode requires clamp_len <= 0"):
        decode.precompute_rel(model, cfg, 64)


def test_prefill_on_the_unfused_path_fills_the_kernel_paths_cache():
    """``prefill`` reads the unfused stack's [G, T, D] hiddens: the same
    K/V as the kernel path's [G, D, T] ones."""
    cfg = dataclasses.replace(MODEL, same_length=True)
    params = random_params(cfg, VOCAB, seed=2)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        1, VOCAB, size=(3, 11)))
    caches = {}
    for impl in ("xla", "pallas"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        model = port_model(params, c, VOCAB)
        with torch.inference_mode():
            caches[impl] = decode.prefill(model, c, tokens,
                                          decode.init_cache(c, 3, 16))
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(caches["xla"], name).numpy(),
                                   getattr(caches["pallas"], name).numpy(),
                                   **TOL)
    np.testing.assert_array_equal(caches["xla"].length.numpy(), [11] * 3)


def test_unfused_dropout_drops_its_share_and_repeats_from_a_seed():
    x = torch.ones(1 << 20)
    dropped = plain_dropout(x, 0.1, torch.Generator().manual_seed(3))
    share = float((dropped == 0).float().mean())
    assert abs(share - 0.1) < 0.005, share
    kept = dropped[dropped != 0]
    torch.testing.assert_close(kept, torch.full_like(kept, 1 / 0.9))
    assert plain_dropout(x, 0.1, None) is x

    cfg = CFG.replace(model=dataclasses.replace(MODEL, dropout=0.1,
                                                attention_dropout=0.1))
    params = random_params(MODEL, VOCAB, seed=3, weight_std=0.05)
    inputs, targets, reset = (torch.from_numpy(a) for a in _batches(4, 1)[0])
    runs = []
    for _ in range(2):
        model = port_model(params, cfg.model, VOCAB)
        opt, sched = make_optimizer(model, cfg)
        step = make_train_step(model, opt, sched, cfg)
        _, metrics = step(init_train_memory(2, B, M, 32, 2), inputs, targets,
                          reset)
        runs.append((float(metrics["nll_sum"]), float(metrics["grad_norm"])))
    model = port_model(params, MODEL, VOCAB)
    opt, sched = make_optimizer(model, CFG)
    _, metrics = make_train_step(model, opt, sched, CFG)(
        init_train_memory(2, B, M, 32, 2), inputs, targets, reset)
    assert runs[0] == runs[1]  # the same seed and step draw the same masks
    assert runs[0][0] != float(metrics["nll_sum"])  # and they do drop


def test_token_nll_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32) * 3
    targets = rng.integers(0, 11, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        token_nll(torch.from_numpy(logits), torch.from_numpy(targets)).numpy(),
        np.asarray(jxl.token_nll(jnp.asarray(logits), jnp.asarray(targets))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_gumbel_softmax_matches_jax_with_a_shared_draw(temperature):
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(3, 4, 13)).astype(np.float32)
    u = rng.uniform(size=logits.shape).astype(np.float32)
    weights = rng.normal(size=logits.shape).astype(np.float32)

    def jax_loss(lg):
        return (jxl.gumbel_softmax(lg, temperature,
                                   u_noise=jnp.asarray(u)) * weights).sum()

    j_out = jxl.gumbel_softmax(jnp.asarray(logits), temperature,
                               u_noise=jnp.asarray(u))
    j_grad = jax.grad(jax_loss)(jnp.asarray(logits))
    t_logits = torch.from_numpy(logits).requires_grad_()
    t_out = gumbel_softmax(t_logits, temperature, u_noise=torch.from_numpy(u))
    (t_out * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_array_equal(t_out.detach().numpy(), np.asarray(j_out))
    assert set(np.unique(t_out.detach().numpy())) <= {0.0, 1.0}
    # the straight-through gradient is the soft sample's
    np.testing.assert_allclose(t_logits.grad.numpy(), np.asarray(j_grad),
                               rtol=1e-5, atol=1e-6)
    drawn = gumbel_softmax(torch.from_numpy(logits), temperature,
                           torch.Generator().manual_seed(0))
    torch.testing.assert_close(drawn.sum(-1), torch.ones(3, 4))


def test_forward_generate_gumbel_matches_jax_over_memory():
    params = random_params(MODEL, VOCAB, seed=5)
    jmodel = jxl.TransformerXL(VOCAB, MODEL)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    model = port_model(params, MODEL, VOCAB)
    rng = np.random.default_rng(5)
    tokens = rng.integers(1, VOCAB, size=(2, 6)).astype(np.int32)
    u = rng.uniform(size=(2, 6, VOCAB)).astype(np.float32)
    j_out, j_mem = jxl.forward_generate_gumbel(
        jmodel, jparams, jnp.asarray(tokens),
        jxl.init_memory(2, 2, 8, 32), 0.8, u_noise=jnp.asarray(u))
    with torch.inference_mode():
        t_out, t_mem = forward_generate_gumbel(
            model, torch.from_numpy(tokens),
            init_memory(2, 2, 8, 32, dense=True), 0.8,
            u_noise=torch.from_numpy(u))
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    np.testing.assert_allclose(t_mem.hidden.numpy(), np.asarray(j_mem.hidden),
                               **TOL)


@pytest.mark.parametrize("flag", ["model.attn_impl=xla", "model.clamp_len=3"])
def test_train_cli_trains_on_the_unfused_path(corpus, tmp_path, flag):
    overrides = ["model.num_layers=2", "model.num_heads=2", "model.units=32",
                 "model.inner_size=48", "train.batch_size=4",
                 "train.batch_chunk=2", "train.tgt_length=16",
                 "train.mem_length=32", "train.warmup_step=2",
                 "train.log_interval=2", "train.eval_interval=2",
                 "evaluate.batch_size=3", "evaluate.tgt_length=16",
                 "evaluate.mem_length=32", flag]
    work = train_cli.main(
        ["--data_dir", str(corpus), "--work_dir", str(tmp_path / "runs"),
         "--device", "cpu", "--dtype", "float32", "--max_step", "2"]
        + [a for o in overrides for a in ("--set", o)])
    text = open(f"{work}/train.log").read()
    assert "attention path=xla" in text
    assert "Train Step 2/2" in text and "Eval step 2" in text
    nll = float(text.split("End of training | test nll")[1].split("|")[0])
    assert np.isfinite(nll)
