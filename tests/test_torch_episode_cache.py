"""The port's decode episode across calls: its reset, its cache (the port of
``jit_sampler.cached_episode``) and, on the card, its captured CUDA graphs
against the eager loop.

The file imports neither jax nor ``commu_tpu``, so on a machine with a card
its ``cuda`` cases run with

    python -m pytest --noconftest -m cuda tests/test_torch_episode_cache.py

(``tests/conftest.py`` imports jax).  Here they skip; the other cases run
the same in-place step on the CPU, eagerly.
"""
import dataclasses

import numpy as np
import pytest
import torch

from commu_tpu_torch.config import InferenceConfig, ModelConfig
from commu_tpu_torch.generation import device_sampler
from commu_tpu_torch.generation.container import GenerationInput
from commu_tpu_torch.models import TransformerXL
from commu_tpu_torch.ops import _build
from commu_tpu_torch.vocab.event_tokens import VOCAB_SIZE
from commu_tpu_torch.vocab.meta_codec import encode_meta

CFG = ModelConfig(num_layers=2, num_heads=2, units=32, inner_size=64,
                  dropout=0.0, attention_dropout=0.0, same_length=True)
ICFG = InferenceConfig(memory_length=512, generation_length=100)
# an episode whose steps cross the 256 view: capacity 384, views [256, 384]
LONG = InferenceConfig(memory_length=512, generation_length=300)
CHORDS_ONE_PER_BAR = ["c"] * 32
CHORDS_MULTI = (["c"] * 4 + ["g"] * 4) * 4
REQUEST = {
    "bpm": 70, "audio_key": "aminor", "time_signature": "4/4",
    "pitch_range": "mid", "num_measures": 4.0, "inst": "acoustic_piano",
    "genre": "newage", "min_velocity": 60, "max_velocity": 80,
    "track_role": "main_melody", "rhythm": "standard",
}


def _model(seed=0):
    """Random weights as ``test_torch_model.random_params`` makes them
    (embedding std 0.5, projections 0.2, biases 0.1, LayerNorm scales near
    1): the logits are far from flat, and at seed 0 every row of both
    prompts runs its full length at temperature 0 and 0.95."""
    model = TransformerXL(VOCAB_SIZE, CFG)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            if name.endswith("layer_norm.weight"):
                p.copy_(1.0 + 0.1 * noise)
            elif name.endswith("bias"):
                p.copy_(0.1 * noise)
            else:
                p.copy_((0.5 if name.startswith("word_emb") else 0.2) * noise)
    return model.eval()


def _input(tmp_path, chords, temperature=0.0):
    return GenerationInput(
        **REQUEST, output_dir=str(tmp_path), num_generate=1, top_k=32,
        temperature=temperature, chord_progression=chords)


def _run(episode, chord_cap, batch, seed, device="cpu"):
    gen = torch.Generator(device=device).manual_seed(seed)
    metas = [list(encode_meta(i.midi_meta())) for i in batch]
    return device_sampler.run_episode(episode, chord_cap, batch, metas, gen)


def _assert_same(ours, ref):
    assert ours[0] == ref[0]
    np.testing.assert_array_equal(ours[1], ref[1])
    np.testing.assert_array_equal(ours[2], ref[2])


@pytest.mark.parametrize("temperature", [0.0, 0.95])
@pytest.mark.parametrize("stale", [False, True])
def test_reused_episode_matches_fresh_episodes(tmp_path, temperature, stale):
    """One episode called twice gives what two fresh episodes give, also
    when NaN (and stale sampler state) is written into its buffers between
    the calls: every call zeroes k and v and resets the state.  A NaN left
    in a value slot would reach the output as 0 x NaN."""
    model = _model()
    first = [_input(tmp_path, CHORDS_ONE_PER_BAR, temperature)] * 2
    second = [dataclasses.replace(
        _input(tmp_path, CHORDS_MULTI, temperature), bpm=120)] * 2
    reused, cap = device_sampler.build_episode(model, CFG, ICFG, first,
                                               chord_cap=8)
    got = [_run(reused, cap, first, 1)]
    if stale:  # the buffers are inference tensors
        state = reused.state
        with torch.inference_mode():
            for buf in (state.cache.k, state.cache.v, state.logits):
                buf.fill_(float("nan"))
            state.banned.fill_(True)
            state.first_loop.fill_(False)
            state.forced.fill_(7)
    got.append(_run(reused, cap, second, 2))
    for batch, seed, ours in ((first, 1, got[0]), (second, 2, got[1])):
        fresh, _ = device_sampler.build_episode(model, CFG, ICFG, batch,
                                                chord_cap=8)
        _assert_same(ours, _run(fresh, cap, batch, seed))
        assert min(map(len, ours[0])) > 12 + 50  # the episode generated
    assert got[0][0] != got[1][0]


def test_episode_cache_reuse(tmp_path):
    """Serving path: repeated execute() calls through one episode_cache
    build once per (width, temp, top_k, chord-cap bucket), and prompts
    whose chord counts land in the same bucket share the episode (the
    assertions of the JAX package's test of the same name)."""
    model = _model()
    cache = {}
    inp4 = _input(tmp_path, CHORDS_ONE_PER_BAR)  # 4 chords
    meta = encode_meta(inp4.midi_meta())
    device_sampler.execute(model, CFG, ICFG, inp4, list(meta), seed=0,
                           validate=False, episode_cache=cache)
    assert len(cache) == 1
    ep_first = cache[next(iter(cache))]

    # same prompt again: no new entry, the identical episode object
    device_sampler.execute(model, CFG, ICFG, inp4, list(meta), seed=1,
                           validate=False, episode_cache=cache)
    assert len(cache) == 1
    assert cache[next(iter(cache))] is ep_first

    # different chord count in the same bucket of 8: still shared
    inp7 = _input(tmp_path, CHORDS_MULTI)
    n7 = len(inp7.chord_token_components["chord_token"])
    assert n7 != 4 and -(-n7 // 8) * 8 == 8  # same bucket as 4
    meta7 = encode_meta(inp7.midi_meta())
    device_sampler.execute(model, CFG, ICFG, inp7, list(meta7), seed=0,
                           validate=False, episode_cache=cache)
    assert len(cache) == 1

    # different sampling params: a new entry
    inp_t = dataclasses.replace(inp4, temperature=0.95)
    device_sampler.execute(model, CFG, ICFG, inp_t, list(meta), seed=0,
                           validate=False, episode_cache=cache)
    assert len(cache) == 2


def test_mixed_sampling_parameters_fail_before_the_lookup(tmp_path):
    """The key carries row 0's temperature and top_k, so a batch that mixes
    them must be refused before the lookup, where a warm entry under row
    0's key would otherwise sample every row with row 0's parameters."""
    model = _model()
    cache = {}
    cold = _input(tmp_path, CHORDS_ONE_PER_BAR)
    hot = dataclasses.replace(cold, temperature=0.95)
    device_sampler.cached_episode(model, CFG, ICFG, [cold, cold], cache)
    assert len(cache) == 1
    with pytest.raises(ValueError, match="temperature/top_k"):
        device_sampler.cached_episode(model, CFG, ICFG, [cold, hot], cache)
    metas = [list(encode_meta(cold.midi_meta()))] * 2
    with pytest.raises(ValueError, match="temperature/top_k"):
        device_sampler.execute_batch(model, CFG, ICFG, [cold, hot], metas,
                                     validate=False, episode_cache=cache)
    assert len(cache) == 1


def test_episode_refuses_another_batch_shape(tmp_path):
    """An episode's buffers (and graphs) are made for one batch width and
    chord capacity: another shape raises instead of reading past them."""
    model = _model()
    batch = [_input(tmp_path, CHORDS_ONE_PER_BAR)] * 2
    episode, cap = device_sampler.build_episode(model, CFG, ICFG, batch,
                                                chord_cap=8)
    _run(episode, cap, batch, 0)
    with pytest.raises(ValueError, match="episode made for G=2"):
        _run(episode, cap, batch * 2, 0)
    with pytest.raises(ValueError, match="C=8; got G=2, T=11, C=16"):
        _run(episode, 16, batch, 0)


def test_captured_launches_move_to_the_replays():
    """A capture's counts come back off ``LAUNCHES`` and each replay adds
    them again."""
    before = dict(_build.LAUNCHES)
    try:
        with _build.captured_launches() as recorded:
            _build.LAUNCHES["cache_append"] += 1  # a wrapper under capture
        assert recorded == {"cache_append": 1}
        assert _build.LAUNCHES == before
        for _ in range(3):
            _build.add_launches(recorded)
        assert _build.LAUNCHES["cache_append"] == before["cache_append"] + 3
    finally:
        _build.LAUNCHES.update(before)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.95])
def test_graphed_episode_matches_eager_loop(dev, tmp_path, temperature):
    """The captured graphs (views 256 and 384) give the eager loop's tokens,
    failed flags and chord_rem, call after call, and leave the caller's
    generator where the eager loop leaves it."""
    model = _model().to(dev)
    batch = [_input(tmp_path, CHORDS_MULTI, temperature)] * 3
    eager, cap = device_sampler.build_episode(model, CFG, LONG, batch,
                                              graphs=False)
    graphed, _ = device_sampler.build_episode(model, CFG, LONG, batch)
    assert graphed.caps == [256, 384]
    gens = [torch.Generator(device=dev).manual_seed(5) for _ in range(2)]
    metas = [list(encode_meta(i.midi_meta())) for i in batch]
    for _ in range(2):  # the second call from where the first left each
        ref = device_sampler.run_episode(eager, cap, batch, metas, gens[0])
        steps = graphed.steps
        ours = device_sampler.run_episode(graphed, cap, batch, metas, gens[1])
        _assert_same(ours, ref)
        assert graphed.steps - steps > 256 - 11  # the 384 view replayed
        assert torch.equal(gens[0].get_state(), gens[1].get_state())


@pytest.mark.cuda
def test_replays_count_cache_append_once_a_step(dev, tmp_path):
    """``LAUNCHES`` counts cache_append once per replayed step (and once
    per eager warm-up step of the first call's capture), never at capture
    time."""
    model = _model().to(dev)
    batch = [_input(tmp_path, CHORDS_ONE_PER_BAR, 0.95)] * 2
    graphed, cap = device_sampler.build_episode(model, CFG, LONG, batch)
    for call in range(2):
        before = _build.LAUNCHES["cache_append"]
        steps, warm = graphed.steps, graphed.capture_steps
        _run(graphed, cap, batch, call, device=dev)
        assert graphed.steps > steps
        assert _build.LAUNCHES["cache_append"] - before == \
            graphed.steps - steps + graphed.capture_steps - warm
    assert graphed.capture_steps == len(graphed.caps)
