"""The PyTorch port's model and checkpoint converter against the JAX package.

Weights are a numpy params tree made from a seed (the flax layout), fed to
the JAX ``TransformerXL`` as they are and to the port through
``state_dict_from_flax_params``.  The JAX model runs both its kernel path
(``attn_impl="pallas"``, Pallas in interpreter mode) and its XLA path.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commu_tpu.config import ModelConfig
from commu_tpu.models.convert import torch_state_from_flax_params
from commu_tpu.models.transformer_xl import Memory as JaxMemory
from commu_tpu.models.transformer_xl import TransformerXL as JaxTransformerXL
from commu_tpu.models.transformer_xl import init_memory
from commu_tpu_torch.models import (DropoutDraw, Memory, TransformerXL,
                                    draw_dropout, load_reference_pt,
                                    state_dict_from_flax_params)
from commu_tpu_torch.ops import prng

CFG = ModelConfig(num_layers=3, num_heads=2, units=32, inner_size=48,
                  dropout=0.0, attention_dropout=0.0)
VOCAB = 50
TOL = 2e-4  # tests/test_decode.py's forward/decode tolerance


def random_params(cfg: ModelConfig, vocab: int, seed: int = 0,
                  weight_std: float = 0.2) -> dict:
    """A flax-layout params tree of numpy arrays (nonzero biases, LayerNorm
    scales near 1) for a ``TransformerXL`` of this config; ``weight_std``
    scales the projection weights."""
    rng = np.random.default_rng(seed)
    d, f = cfg.units, cfg.inner_size
    hd = cfg.units // cfg.num_heads * cfg.num_heads

    def n(*shape, std=weight_std):
        return (rng.normal(size=shape) * std).astype(np.float32)

    def ln():
        return {"scale": 1.0 + n(d, std=0.1), "bias": n(d, std=0.1)}

    params = {"embedding": n(vocab, d, std=0.5), "out_bias": n(vocab, std=0.1),
              "r_w_bias": n(cfg.num_heads, d // cfg.num_heads),
              "r_r_bias": n(cfg.num_heads, d // cfg.num_heads)}
    for i in range(cfg.num_layers):
        params[f"layer_{i}"] = {
            "attn": {"q_net": {"kernel": n(d, hd)},
                     "kv_net": {"kernel": n(d, 2 * hd)},
                     "r_net": {"kernel": n(d, hd)},
                     "o_net": {"kernel": n(hd, d)},
                     "layer_norm": ln()},
            "ff": {"ff1": {"kernel": n(d, f), "bias": n(f, std=0.1)},
                   "ff2": {"kernel": n(f, d), "bias": n(d, std=0.1)},
                   "layer_norm": ln()},
        }
    return params


def port_model(params: dict, cfg: ModelConfig, vocab: int) -> TransformerXL:
    model = TransformerXL(vocab, cfg)
    model.load_state_dict(state_dict_from_flax_params(params, cfg))
    return model.eval()


def test_converter_matches_jax_converter():
    params = random_params(CFG, VOCAB)
    ours = state_dict_from_flax_params(params, CFG)
    ref = torch_state_from_flax_params(params, CFG)
    assert set(ours) == set(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)
    # the port's parameter names are the reference's state-dict names
    assert set(TransformerXL(VOCAB, CFG).state_dict()) == set(ref)


def test_load_reference_pt_roundtrip(tmp_path):
    from commu_tpu.training.checkpoint import export_torch

    params = random_params(CFG, VOCAB, seed=1)
    path = tmp_path / "model.pt"
    export_torch(params, path, cfg=CFG)
    model = TransformerXL(VOCAB, CFG)
    model.load_state_dict(load_reference_pt(path))
    for key, value in state_dict_from_flax_params(params, CFG).items():
        torch.testing.assert_close(model.state_dict()[key], value, rtol=0,
                                   atol=0, msg=key)
    # tied output embedding
    assert model.crit.out_layers[0].weight is model.word_emb.emb_layers[0].weight


# the JAX XLA path's mask blocks whole rows under same_length with an empty
# memory (NaN logits), so same_length is held against its kernel path only
@pytest.mark.parametrize("attn_impl,same_length", [
    ("pallas", False), ("pallas", True), ("xla", False)])
def test_forward_logits_and_hiddens_match_jax(attn_impl, same_length):
    cfg = dataclasses.replace(CFG, attn_impl=attn_impl)
    params = random_params(cfg, VOCAB, seed=2)
    rng = np.random.default_rng(5)
    b, t = 3, 11
    tokens = rng.integers(1, VOCAB, size=(b, t)).astype(np.int32)
    reset = np.array([False, True, False])

    jmodel = JaxTransformerXL(VOCAB, cfg, dtype=jnp.float32)
    memory = init_memory(cfg.num_layers, b, 0, cfg.units)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    out, _, hids = jmodel.apply({"params": jparams}, jnp.asarray(tokens),
                                memory, jnp.asarray(reset),
                                same_length=same_length,
                                method=jmodel.forward, return_hiddens=True)
    logits, _ = jmodel.apply({"params": jparams}, jnp.asarray(tokens), memory,
                             jnp.asarray(reset), same_length=same_length)

    model = port_model(params, cfg, VOCAB)
    with torch.inference_mode():
        t_out, t_hids = model(torch.from_numpy(tokens).long(),
                              torch.from_numpy(reset),
                              same_length=same_length, return_hiddens=True)
        t_logits = model.logits(t_out)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(out),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits),
                               rtol=TOL, atol=TOL)
    assert len(t_hids) == len(hids) == cfg.num_layers + 1
    # each path keeps the JAX path's orientation: [B, D, T] on the kernel
    # path, [B, T, D] on the unfused (XLA) one
    for i, (ours, ref) in enumerate(zip(t_hids, hids)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=TOL,
                                   atol=TOL, err_msg=f"hidden {i}")


def test_bf16_compute_with_f32_params_matches_jax():
    """The JAX trainer keeps f32 parameters and computes in bf16
    (``TransformerXL(dtype=jnp.bfloat16)``); the port's ``dtype`` does the
    same.  Casting the parameters themselves to bf16 (the serving path's
    ``model.to``) rounds the embedding, biases and LayerNorm parameters too,
    and lands measurably further from that reference."""
    cfg = dataclasses.replace(CFG, attn_impl="pallas")
    params = random_params(cfg, VOCAB, seed=4, weight_std=0.05)
    rng = np.random.default_rng(4)
    b, t = 3, 11
    tokens = rng.integers(1, VOCAB, size=(b, t)).astype(np.int32)
    jmodel = JaxTransformerXL(VOCAB, cfg, dtype=jnp.bfloat16)
    out, _ = jmodel.apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, params)},
        jnp.asarray(tokens), init_memory(cfg.num_layers, b, 0, cfg.units,
                                         dtype=jnp.bfloat16),
        method=jmodel.forward)
    ref = np.asarray(out, np.float32)

    model = TransformerXL(VOCAB, cfg, dtype=torch.bfloat16)
    model.load_state_dict(state_dict_from_flax_params(params, cfg))
    assert model.embedding.dtype == torch.float32
    cast = port_model(params, cfg, VOCAB).to(torch.bfloat16)
    with torch.inference_mode():
        ours = model(torch.from_numpy(tokens).long())
        theirs = cast(torch.from_numpy(tokens).long())
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=2e-2,
                               atol=2e-2)
    err = np.abs(ours.float().numpy() - ref).max()
    assert err < np.abs(theirs.float().numpy() - ref).max()


def test_init_parameters_is_seeded_and_jax_shaped():
    a, b = TransformerXL(VOCAB, CFG), TransformerXL(VOCAB, CFG)
    a.init_parameters(torch.Generator().manual_seed(3))
    b.init_parameters(torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=name)
    ln = a.layers[0].pos_ff.layer_norm
    assert torch.all((ln.weight - 1.0).abs() < 0.1)
    assert torch.count_nonzero(ln.bias) == 0
    assert torch.count_nonzero(a.out_bias) == 0
    assert 0.005 < float(a.embedding.std()) < 0.015


def record_jax_draws(monkeypatch):
    """Wrap ``jax.random.randint`` and ``jax.random.bernoulli`` so that an
    un-jitted JAX forward leaves what it drew in the returned list, in call
    order: ("mask", bool array) for the positional dropout and ("seed", int)
    for each kernel seed.  Nothing in the JAX package changes."""
    drawn = []
    randint, bernoulli = jax.random.randint, jax.random.bernoulli

    def rec_randint(*args, **kwargs):
        value = randint(*args, **kwargs)
        drawn.append(("seed", int(value)))
        return value

    def rec_bernoulli(*args, **kwargs):
        value = bernoulli(*args, **kwargs)
        drawn.append(("mask", np.array(value)))
        return value

    monkeypatch.setattr(jax.random, "randint", rec_randint)
    monkeypatch.setattr(jax.random, "bernoulli", rec_bernoulli)
    return drawn


def draw_from_record(drawn) -> DropoutDraw:
    """The port's ``DropoutDraw`` of one recorded JAX forward (its order:
    psi mask, embedding seed, each layer's attention then FFN seed, output
    seed)."""
    seeds = [v for kind, v in drawn if kind == "seed"]
    (mask,) = [v for kind, v in drawn if kind == "mask"]
    return DropoutDraw(seeds[0], seeds[-1], seeds[1:-1:2], seeds[2:-1:2],
                       torch.from_numpy(mask))


@pytest.mark.parametrize("dtype,mem_cap", [
    ("float32", 22), ("bfloat16", 22), ("float32", 0)])
def test_forward_with_dropout_matches_jax_from_the_recorded_draws(
        dtype, mem_cap, monkeypatch):
    """``deterministic=False`` at dropout 0.1 and attention dropout 0.1: the
    JAX forward runs un-jitted and its seeds and psi mask go to the port.
    With a memory: ``forward_train`` over a partly filled ring and its rows;
    without (capacity 0): ``forward``, through the no-memory attention."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tol = TOL if dtype == "float32" else 2e-2
    cfg = dataclasses.replace(CFG, attn_impl="pallas", dropout=0.1,
                              attention_dropout=0.1)
    params = random_params(cfg, VOCAB, seed=7,
                           weight_std=0.2 if dtype == "float32" else 0.05)
    rng = np.random.default_rng(8)
    b, t = 3, 11
    tokens = rng.integers(1, VOCAB, size=(b, t)).astype(np.int32)
    reset = np.array([False, True, False])
    hidden = (rng.normal(size=(cfg.num_layers + 1, max(mem_cap // t, 1), b,
                               cfg.units, t if mem_cap else 0)) * 0.5
              ).astype(np.float32)
    count, head = (t, t) if mem_cap else (0, 0)

    jmodel = JaxTransformerXL(VOCAB, cfg, dtype=jdt)
    jmem = JaxMemory(hidden=jnp.asarray(hidden).astype(jdt),
                     count=jnp.int32(count), head=jnp.int32(head),
                     transposed=True) if mem_cap else init_memory(
                         cfg.num_layers, b, 0, cfg.units)
    drawn = record_jax_draws(monkeypatch)
    with jax.disable_jit():
        out, _, hids = jmodel.apply(
            {"params": jax.tree_util.tree_map(jnp.asarray, params)},
            jnp.asarray(tokens), jmem, jnp.asarray(reset),
            deterministic=False, return_hiddens=True, method=jmodel.forward,
            rngs={"dropout": jax.random.PRNGKey(3)})
    assert [kind for kind, _ in drawn] == ["mask"] + ["seed"] * (
        2 * cfg.num_layers + 2)
    draw = draw_from_record(drawn)

    model = TransformerXL(VOCAB, cfg, dtype=tdt)
    model.load_state_dict(state_dict_from_flax_params(params, cfg))
    toks, rst = torch.from_numpy(tokens).long(), torch.from_numpy(reset)
    if mem_cap:
        memory = Memory(torch.from_numpy(hidden).to(tdt), count, head)
        t_out, t_hids = model.forward_train(toks, rst, memory, dropout=draw)
        assert t_out.requires_grad and not t_hids[0].requires_grad
        assert (memory.count, memory.head) == (count, head)  # not advanced
    else:
        with torch.no_grad():
            t_out, t_hids = model(toks, rst, return_hiddens=True,
                                  dropout=draw)
        # autograd on: the same values, with the no-memory backward behind
        grad_out = model(toks, rst, dropout=draw)
        assert grad_out.requires_grad and torch.equal(grad_out.detach(), t_out)
    np.testing.assert_allclose(t_out.detach().float().numpy(),
                               np.asarray(out.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    for i, (ours, ref) in enumerate(zip(t_hids, hids)):
        np.testing.assert_allclose(ours.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   rtol=tol, atol=tol, err_msg=f"hidden {i}")
    # the embedding dropout shows in the first row, the output dropout only
    # in the output
    assert float((t_hids[0] == 0).float().mean()) > 0.05
    assert float((t_out == 0).float().mean()) > 0.05
    assert float((t_hids[-1] == 0).float().mean()) < 0.01


def test_draw_dropout_is_seeded_and_shaped():
    cfg = dataclasses.replace(CFG, dropout=0.1, attention_dropout=0.1)
    a = draw_dropout(torch.Generator().manual_seed(5), cfg, 40)
    b = draw_dropout(torch.Generator().manual_seed(5), cfg, 40)
    c = draw_dropout(torch.Generator().manual_seed(6), cfg, 40)
    assert a.psi_keep.shape == (256, 40) and a.psi_keep.dtype == torch.bool
    assert abs(float(a.psi_keep.float().mean()) - 0.9) < 0.02
    assert torch.equal(a.psi_keep, prng.keep_mask(
        int(torch.randint(0, 2 ** 31 - 1, (1,),
                          generator=torch.Generator().manual_seed(5))),
        (256, 40), 0.1))
    assert len(a.attn_seeds) == len(a.ffn_seeds) == cfg.num_layers
    seeds = [a.emb_seed, a.out_seed, *a.attn_seeds, *a.ffn_seeds]
    assert len(set(seeds)) == len(seeds)
    assert all(0 <= s < 2 ** 31 - 1 for s in seeds)
    assert torch.equal(a.psi_keep, b.psi_keep) and a.attn_seeds == b.attn_seeds
    assert a.emb_seed != c.emb_seed and not torch.equal(a.psi_keep, c.psi_keep)
