"""The PyTorch port's device sampler and serving CLI, on the CPU.

Temperature 0 makes the episode deterministic, so the port's sampler must
produce the JAX ``jit_sampler``'s tokens exactly under the same weights.
At temperature > 0 the two draw from different generators: the port's
candidate weights and draw are held against the analytic distribution
instead.
"""
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commu_tpu.config import InferenceConfig, ModelConfig, TrainingConfig
from commu_tpu.generation import jit_sampler
from commu_tpu.models.transformer_xl import TransformerXL as JaxTransformerXL
from commu_tpu.vocab.event_tokens import VOCAB_SIZE
from commu_tpu.vocab.meta_codec import encode_meta
from commu_tpu_torch.generation import device_sampler
from commu_tpu_torch.generation.container import GenerationInput
from commu_tpu_torch.generation.postprocess import read_midi
from commu_tpu_torch.models import TransformerXL

from conftest import REPO_ROOT
from test_torch_model import port_model, random_params

GEN_LEN = 100
CFG = ModelConfig(num_layers=2, num_heads=2, units=32, inner_size=64,
                  dropout=0.0, attention_dropout=0.0, same_length=True)
ICFG = InferenceConfig(memory_length=512, generation_length=GEN_LEN)
CHORDS_ONE_PER_BAR = ["c"] * 32
CHORDS_MULTI = (["c"] * 4 + ["g"] * 4) * 4
REQUEST = {
    "bpm": 70, "audio_key": "aminor", "time_signature": "4/4",
    "pitch_range": "mid", "num_measures": 4.0, "inst": "acoustic_piano",
    "genre": "newage", "min_velocity": 60, "max_velocity": 80,
    "track_role": "main_melody", "rhythm": "standard",
}


def _input_data(tmp_path, chords, temperature=0.0):
    return GenerationInput(
        **REQUEST, output_dir=str(tmp_path), num_generate=1, top_k=32,
        temperature=temperature, chord_progression=chords)


@pytest.mark.parametrize("chords,seed", [(CHORDS_ONE_PER_BAR, 1),
                                         (CHORDS_MULTI, 2)])
def test_device_sampler_matches_jit_sampler(tmp_path, chords, seed):
    params = random_params(CFG, VOCAB_SIZE, seed)
    inp = _input_data(tmp_path, chords)
    meta = list(encode_meta(inp.midi_meta()))
    batch = [inp] * 2

    jmodel = JaxTransformerXL(vocab_size=VOCAB_SIZE, cfg=CFG)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    episode, chord_cap = jit_sampler.build_episode(
        jmodel, jparams, CFG, ICFG, batch, capacity=GEN_LEN + 16)
    ref = jit_sampler.run_episode(episode, chord_cap, batch, [meta] * 2,
                                  jax.random.PRNGKey(0))

    model = port_model(params, CFG, VOCAB_SIZE)
    episode, chord_cap = device_sampler.build_episode(
        model, CFG, ICFG, batch, capacity=GEN_LEN + 16)
    ours = device_sampler.run_episode(episode, chord_cap, batch, [meta] * 2,
                                      torch.Generator().manual_seed(0))
    assert ours[0] == ref[0]
    assert len(ours[0][0]) > 12 + 20  # the episode really generated
    np.testing.assert_array_equal(ours[1], ref[1])
    np.testing.assert_array_equal(ours[2], ref[2])


def test_segment_views_follow_the_step_count():
    assert device_sampler._segment_caps(4096) == [256, 512, 1024, 2048, 4096]
    assert device_sampler._segment_caps(1152) == [256, 512, 1024, 1152]
    assert device_sampler._segment_caps(116) == [116]


def _chi2_ok(counts, expected):
    support = expected > 0
    assert counts[~support].sum() == 0, "draw outside the candidate set"
    chi2 = float(((counts[support] - expected[support]) ** 2
                  / expected[support]).sum())
    dof = int(support.sum()) - 1
    assert chi2 < dof + 8.0 * np.sqrt(2.0 * dof), (chi2, dof)


@pytest.mark.parametrize("banned_ids,top_k", [([], 32), (None, 32), (None, 3)])
def test_masked_probs_and_draw_distribution(banned_ids, top_k):
    """Top-k BEFORE the ban, at temperature 0.95: the candidate set equals
    the analytic one and the draws follow its renormalized distribution."""
    temperature, n_draws = 0.95, 100_000
    rng = np.random.default_rng(11)
    logits = rng.normal(size=VOCAB_SIZE - 1).astype(np.float32) * 3.0
    probs = np.exp((logits / temperature).astype(np.float64)
                   - (logits / temperature).max())
    probs = np.concatenate([[0.0], probs / probs.sum()])
    top_idx = np.argsort(-probs, kind="stable")[:top_k]
    if banned_ids is None:  # ban inside the top-k: renormalize over fewer
        banned_ids = [int(top_idx[i]) for i in (1, 4) if i < top_k]
    mask = np.zeros_like(probs)
    mask[top_idx] = 1.0
    mask[banned_ids] = 0.0
    analytic = probs * mask
    analytic /= analytic.sum()

    banned = torch.zeros((1, VOCAB_SIZE), dtype=torch.bool)
    banned[0, banned_ids] = True
    port_probs = torch.nn.functional.pad(
        torch.softmax(torch.from_numpy(logits) / temperature, dim=-1), (1, 0))
    masked = device_sampler.masked_probs(port_probs[None], banned, top_k)
    np.testing.assert_array_equal(masked[0].numpy() > 0, analytic > 0)

    gen = torch.Generator().manual_seed(2)
    counts = np.zeros(VOCAB_SIZE, dtype=np.int64)
    for _ in range(10):
        draws = device_sampler.draw_categorical(
            masked.expand(n_draws // 10, -1), gen)
        counts += np.bincount(draws.numpy(), minlength=VOCAB_SIZE)
    _chi2_ok(counts, analytic * n_draws)


def test_serve_cli_writes_midi_on_cpu(tmp_path):
    """``python -m commu_tpu_torch.generate --device cpu --serve --lenient``
    answers two requests with .mid files that parse back."""
    work = tmp_path / "work"
    work.mkdir()
    model = TransformerXL(VOCAB_SIZE, CFG)
    model.init_parameters(torch.Generator().manual_seed(0))
    torch.save({"model": model.state_dict()}, work / "model.pt")
    (work / "config.yml").write_text(TrainingConfig(model=CFG).to_yaml())

    requests = [
        {**REQUEST, "request_id": "a",
         "chord_progression": "-".join(CHORDS_ONE_PER_BAR)},
        {**REQUEST, "request_id": "b", "num_generate": 2, "seed": 3,
         "chord_progression": "-".join(CHORDS_MULTI)},
    ]
    out_dir = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "commu_tpu_torch.generate", "--device", "cpu",
         "--serve", "--lenient", "--gen_length", "64",
         "--checkpoint_dir", str(work / "model.pt"),
         "--output_dir", str(out_dir)],
        input="".join(json.dumps(r) + "\n" for r in requests),
        capture_output=True, text=True, cwd=REPO_ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    assert lines[0]["status"] == "ready"
    responses = {r["request_id"]: r for r in lines[1:]}
    assert set(responses) == {"a", "b"}
    n_files = {"a": 1, "b": 2}
    for rid, resp in responses.items():
        assert resp["ok"], resp
        assert len(resp["files"]) == n_files[rid]
        # the plain versions ran: no kernel launched on the CPU, and the
        # episode stepped eagerly (no capture)
        assert set(resp["kernel_launches"].values()) == {0}
        assert resp["decode_steps"] > 0 and resp["capture_steps"] == 0
        for path in resp["files"]:
            midi = read_midi(path)
            assert midi.ticks_per_beat > 0
    assert len(set(responses["a"]["files"] + responses["b"]["files"])) == 3
