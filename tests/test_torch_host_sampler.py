"""The port's host-parity sampler (``generation/host_sampler.py``) on the
CPU: token for token against ``commu_tpu.generation.host_sampler`` on the
same weights, chords and numpy seeds (the draw is numpy's in both, so
temperature 0.95 compares exactly too), against the port's device sampler
at temperature 0, and the generate CLI with ``--sampler host``."""
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commu_tpu.config import InferenceConfig, ModelConfig
from commu_tpu.generation import host_sampler as jax_host
from commu_tpu.models.transformer_xl import TransformerXL as JaxTransformerXL
from commu_tpu.vocab.event_tokens import VOCAB_SIZE
from commu_tpu.vocab.meta_codec import encode_meta
from commu_tpu_torch import generate
from commu_tpu_torch.generation import MidiGenerationPipeline, device_sampler
from commu_tpu_torch.generation import host_sampler
from commu_tpu_torch.generation.container import GenerationInput
from commu_tpu_torch.generation.postprocess import read_midi

from test_torch_generation import (CHORDS_MULTI, CHORDS_ONE_PER_BAR, REQUEST,
                                   _input_data)
from test_torch_model import port_model, random_params

GEN_LEN = 100
CFG = ModelConfig(num_layers=2, num_heads=2, units=32, inner_size=64,
                  dropout=0.0, attention_dropout=0.0, same_length=True)
ICFG = InferenceConfig(memory_length=512, generation_length=GEN_LEN)


@pytest.mark.parametrize("chords,seed", [(CHORDS_ONE_PER_BAR, 1),
                                         (CHORDS_MULTI, 2)])
@pytest.mark.parametrize("temperature", [0.0, 0.95])
def test_execute_matches_jax_host_sampler(tmp_path, chords, seed,
                                          temperature):
    params = random_params(CFG, VOCAB_SIZE, seed)
    inp = _input_data(tmp_path, chords, temperature)
    meta = list(encode_meta(inp.midi_meta()))
    jmodel = JaxTransformerXL(vocab_size=VOCAB_SIZE, cfg=CFG)
    jengine = jax_host.InferenceEngine(
        jmodel, jax.tree_util.tree_map(jnp.asarray, params), CFG, ICFG,
        capacity=GEN_LEN + 16)
    ref = jax_host.execute(jengine, inp, meta, seed=seed + 10, validate=False)
    engine = host_sampler.InferenceEngine(port_model(params, CFG, VOCAB_SIZE),
                                          CFG, ICFG, capacity=GEN_LEN + 16)
    ours = host_sampler.execute(engine, inp, meta, seed=seed + 10,
                                validate=False)
    assert ours == ref
    assert len(ours[0]) > 12 + 20  # the episode really generated
    assert engine.steps > 20


@pytest.mark.parametrize("chords,seed", [(CHORDS_ONE_PER_BAR, 1),
                                         (CHORDS_MULTI, 2)])
def test_host_loop_matches_the_device_sampler_at_temperature_0(
        tmp_path, chords, seed):
    params = random_params(CFG, VOCAB_SIZE, seed)
    inp = _input_data(tmp_path, chords)
    meta = list(encode_meta(inp.midi_meta()))
    model = port_model(params, CFG, VOCAB_SIZE)
    engine = host_sampler.InferenceEngine(model, CFG, ICFG,
                                          capacity=GEN_LEN + 16)
    seq, cache = engine.prime(meta)
    host_seq = host_sampler.generate_sequence(
        engine, inp, seq, cache, np.random.default_rng(0))
    batch = [inp] * 2  # two identical rows must agree at temperature 0
    episode, chord_cap = device_sampler.build_episode(
        model, CFG, ICFG, batch, capacity=GEN_LEN + 16)
    outs, failed, rems = device_sampler.run_episode(
        episode, chord_cap, batch, [meta] * 2,
        torch.Generator().manual_seed(0))
    for g in range(2):
        if host_seq is None:
            assert failed[g] or not device_sampler._validate(
                inp, outs[g], int(rems[g]))
        else:
            assert not failed[g]
            assert outs[g] == host_seq, f"row {g}"


def test_sample_from_logits_tempers_stale_logits_again():
    """The in-place temperature divide: a reuse after a ban sees logits
    already divided once."""
    logits = np.array([1.0, 2.0, 4.0], dtype=np.float32)
    rng = np.random.default_rng(0)
    _, first = host_sampler.sample_from_logits(logits, 0.5, 3, [], rng,
                                               return_probs=True)
    np.testing.assert_allclose(logits, [2.0, 4.0, 8.0])
    _, again = host_sampler.sample_from_logits(logits, 0.5, 3, [3], rng,
                                               return_probs=True)
    np.testing.assert_allclose(logits, [4.0, 8.0, 16.0])
    assert again[3] == 0.0 and abs(again.sum() - 1.0) < 1e-12
    assert again[2] / again[1] > first[2] / first[1]
    with pytest.raises(host_sampler.SamplingError):
        host_sampler.sample_from_logits(np.zeros(3, np.float32), 0.0, 1,
                                        [1], rng)


def test_host_engine_refuses_clamp_len():
    cfg = dataclasses.replace(CFG, clamp_len=4)
    model = port_model(random_params(cfg, VOCAB_SIZE), cfg, VOCAB_SIZE)
    with pytest.raises(NotImplementedError, match="clamp_len"):
        host_sampler.InferenceEngine(model, cfg, ICFG)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    from commu_tpu.training.checkpoint import export_torch

    path = tmp_path_factory.mktemp("ckpt") / "model.pt"
    export_torch(random_params(CFG, VOCAB_SIZE, 3), path, cfg=CFG)
    (path.parent / "config.yml").write_text(
        "MODEL:\n" + "".join(f"  {f.name}: {getattr(CFG, f.name)}\n"
                             for f in dataclasses.fields(CFG)))
    return path


def test_pipeline_host_sampler_counts_its_steps(checkpoint, tmp_path):
    pipeline = MidiGenerationPipeline(
        str(checkpoint), inference_cfg=ICFG, device="cpu", sampler="host")
    inp = GenerationInput.from_dict({
        **REQUEST, "output_dir": str(tmp_path), "num_generate": 2,
        "top_k": 32, "temperature": 0.95,
        "chord_progression": "-".join(CHORDS_ONE_PER_BAR)})
    sequences = pipeline.generate_sequences(inp, seed=1, validate=False)
    assert len(sequences) == 2 and sequences[0] != sequences[1]
    assert pipeline.episode_totals()["decode_steps"] > 2 * 20
    assert not pipeline.episode_cache  # no device episode was built
    with pytest.raises(ValueError, match="sampler"):
        MidiGenerationPipeline(str(checkpoint), device="cpu", sampler="gpu")


def test_generate_cli_host_sampler_single_request_and_serve(checkpoint,
                                                            tmp_path):
    flags = ["--device", "cpu", "--sampler", "host", "--lenient",
             "--gen_length", "64", "--checkpoint_dir", str(checkpoint)]
    meta = [a for k, v in REQUEST.items() for a in (f"--{k}", str(v))]
    out = io.StringIO()
    generate.main(flags + meta + [
        "--output_dir", str(tmp_path / "single"), "--num_generate", "2",
        "--seed", "4", "--chord_progression", "-".join(CHORDS_MULTI)],
        stdout=out)
    assert "Generated files under" in out.getvalue()
    files = sorted((tmp_path / "single").rglob("*.mid"))
    assert len(files) == 2
    for path in files:
        read_midi(str(path))

    out = io.StringIO()
    request = {**REQUEST, "chord_progression": "-".join(CHORDS_ONE_PER_BAR),
               "request_id": "r1", "seed": 2, "temperature": 0.95}
    generate.main(flags + ["--serve", "--output_dir",
                           str(tmp_path / "served")],
                  stdin=io.StringIO(json.dumps(request) + "\n"), stdout=out)
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    assert lines[0]["status"] == "ready"
    assert lines[1]["ok"] and lines[1]["request_id"] == "r1", lines[1]
    assert lines[1]["decode_steps"] > 20 and lines[1]["capture_steps"] == 0
    for path in lines[1]["files"]:
        read_midi(path)
