"""Batched sampling loop over device tensors (the serving path).

PyTorch counterpart of ``commu_tpu/generation/jit_sampler.py``.  The whole
episode — prefill, KV-cache decode, temperature/top-k sampling and the
chord teacher-forcing state machine — runs on the device for G rows in
lock-step; the host only drives the loop.  The state machine is the
TeacherForcer translated to vector state:

    forced[g]       pending forced token (-1 none; queue depth is provably <=1)
    banned[g, V]    tokens banned for sampling (wrong chord tokens)
    no_seq[g]       reuse stale logits without a forward (banned-token path)
    first_loop[g]   first sampling forward does not commit to the cache
    chord_head[g]   cursor into the padded per-row chord schedule
    bar_count[g]    Bar tokens emitted so far
    incomplete[g]   whether the pickup-measure flag has been satisfied

with the reference's quirks kept: forced tokens are committed to the cache
twice, the temperature divides the reused logits in place, bans leave the
logits stale, and top-k is taken BEFORE the ban.

Host-side loop control, without a device sync per step:
- lengths grow by at most one per step, so the cache view each step reads
  (doubling 128-aligned widths 256, 512, ... up to the capacity) is chosen
  from the step count alone; the view only bounds the masked attention, so
  the tokens do not depend on it;
- steps after every row is done or failed change nothing, so termination
  is polled every ``POLL_EVERY`` steps.

The jitted ``lax.while_loop`` of the reference becomes, on a CUDA device,
one captured CUDA graph of the in-place step per cache view, replayed once
per step from static buffers (``Episode``); ``cached_episode`` keeps the
episodes, graphs and all, across requests as the reference keeps its
executables.  On the CPU the same step runs eagerly.

Sampling draws Gumbel noise from an explicit ``torch.Generator``; it does
not reproduce ``jax.random``'s bits.  At temperature 0 the draw is the
argmax, so the tokens are deterministic.  ``torch.topk`` does not promise
the lower-index tie-break of ``jax.lax.top_k``: at temperature > 0 two
exactly equal probabilities at the top-k boundary may select differently.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import List, Optional

import numpy as np
import torch

from ..config import InferenceConfig, ModelConfig
from ..utils.constants import DEFAULT_POSITION_RESOLUTION
from ..vocab.event_tokens import BAR_ID, EOS_ID, TokenOffset, VOCAB_SIZE

from ..models.decode import (KVCache, commit, decode_step, init_cache,
                             precompute_rel, prefill)
from ..ops import _build
from .teacher import validate_generated_sequence

logger = logging.getLogger("ComMU")

_POSITION = int(TokenOffset.POSITION)
_CHORD_START = int(TokenOffset.CHORD_START)
_CHORD_END = int(TokenOffset.CHORD_END)
POLL_EVERY = 32


@dataclasses.dataclass
class SamplerState:
    seq: torch.Tensor          # [G, S] int32
    seq_len: torch.Tensor      # [G] int32
    cache: KVCache
    logits: torch.Tensor       # [G, V-1] f32 (token 0 stripped, reference layout)
    forced: torch.Tensor       # [G] int32, -1 = none
    banned: torch.Tensor       # [G, V] bool
    no_seq: torch.Tensor       # [G] bool
    first_loop: torch.Tensor   # [G] bool
    chord_head: torch.Tensor   # [G] int32
    chord_rem: torch.Tensor    # [G] int32
    bar_count: torch.Tensor    # [G] int32
    incomplete_filled: torch.Tensor  # [G] bool
    done: torch.Tensor         # [G] bool
    failed: torch.Tensor       # [G] bool


def _gather_row(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[g, idx[g]] with clipping."""
    idx = idx.clamp(0, arr.shape[1] - 1).long()
    return arr.gather(1, idx[:, None])[:, 0]


def masked_probs(probs: torch.Tensor, banned: torch.Tensor,
                 top_k: int) -> torch.Tensor:
    """Top-k-then-ban candidate weights (midi_inferrer.py:224-233: a banned
    token inside the top-k shrinks the candidate set rather than admitting
    the (k+1)-th).  Returns UNNORMALIZED weights."""
    _, topi = torch.topk(probs, top_k, dim=-1)
    topk_mask = torch.zeros_like(probs).scatter_(1, topi, 1.0)
    return probs * topk_mask * (~banned)


def draw_categorical(weights: torch.Tensor,
                     generator: torch.Generator) -> torch.Tensor:
    """One index per row with probability proportional to ``weights`` (the
    Gumbel-max form of ``jax.random.categorical`` over log-weights)."""
    u = torch.rand(weights.shape, generator=generator, device=weights.device)
    logw = torch.log(torch.clamp(weights, min=1e-38))
    return torch.argmax(logw - torch.log(-torch.log(u)), dim=-1)


def _segment_caps(capacity: int) -> List[int]:
    """Cache-view widths of the decode loop: 256, 512, ... below the
    capacity, then the capacity (a single view when it is not 128-aligned)."""
    if capacity % 128:
        return [capacity]
    caps, c = [], 256
    while c < capacity:
        caps.append(c)
        c *= 2
    caps.append(capacity)
    return caps


class Episode:
    """The episode: (primer, chord schedule, lengths, generator) -> final
    state.  Per-row metadata arrays allow heterogeneous prompts.

    It owns static buffers for the state (the full KV cache among them), the
    extras and the primer, made at the first call for its batch width and
    chord capacity; every call resets them (the cache to zero, as
    ``init_cache`` makes it) and returns them: the state is valid until the
    next call.  One step function, ``step``, updates the state in place.  On
    a CUDA device it runs as a captured CUDA graph per cache view (made at
    the first call, all in one memory pool, with the episode's own generator
    registered, whose state is copied from the caller's generator before the
    steps and back after them), replayed once per step; ``graphs=False``
    runs it eagerly there, as on the CPU.  A capture that fails raises."""

    def __init__(self, model, cfg: ModelConfig, icfg: InferenceConfig, *,
                 capacity: int, seq_buf: int, temperature: float, top_k: int,
                 graphs: bool = True):
        self.model, self.cfg = model, cfg
        self.capacity, self.seq_buf = capacity, seq_buf
        self.temperature, self.top_k = temperature, top_k
        self.gen_len = icfg.generation_length
        self.caps = _segment_caps(capacity)
        self.device = model.embedding.device
        self.rel = precompute_rel(model, cfg, capacity)
        self.graphs = graphs and self.device.type == "cuda"
        self.state: Optional[SamplerState] = None
        self.extras = self.primer = self._slots = None
        self._graphs = {}      # view -> (CUDAGraph, launches of one replay)
        self._generator = None  # registered with every graph
        self.steps = 0          # decode steps of every call so far
        self.capture_steps = 0  # eager warm-up steps before the captures
        self.capture_seconds = 0.0

    def _allocate(self, g_dim: int, c_dim: int, t: int) -> None:
        dev = self.device

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.primer = zeros(g_dim, t, dtype=torch.long)
        self.state = SamplerState(
            seq=zeros(g_dim, self.seq_buf), seq_len=zeros(g_dim),
            cache=init_cache(self.cfg, g_dim, self.capacity,
                             dtype=self.model.embedding.dtype, device=dev),
            logits=zeros(g_dim, VOCAB_SIZE - 1, dtype=torch.float32),
            forced=zeros(g_dim), banned=zeros(g_dim, VOCAB_SIZE,
                                             dtype=torch.bool),
            no_seq=zeros(g_dim, dtype=torch.bool),
            first_loop=zeros(g_dim, dtype=torch.bool),
            chord_head=zeros(g_dim), chord_rem=zeros(g_dim),
            bar_count=zeros(g_dim),
            incomplete_filled=zeros(g_dim, dtype=torch.bool),
            done=zeros(g_dim, dtype=torch.bool),
            failed=zeros(g_dim, dtype=torch.bool))
        # chord_tok, chord_pos, inter_flag, length_fit, row_cap
        self.extras = (zeros(g_dim, c_dim), zeros(g_dim, c_dim),
                       zeros(g_dim, c_dim, dtype=torch.bool),
                       zeros(g_dim, dtype=torch.bool), zeros(g_dim))
        self._slots = torch.arange(self.seq_buf, device=dev)[None, :]

    def step(self, generator: torch.Generator, view: int) -> None:
        """One decode step for every row, written into the state's tensors
        (``commit`` writes k and v in place; the new length is copied)."""
        state, seq_buf = self.state, self.seq_buf
        chord_tok, chord_pos, inter_flag, length_fit, row_cap = self.extras
        slots = self._slots
        active = ~(state.done | state.failed)

        # ---- phase A: append pending forced token --------------------
        has_forced = active & (state.forced >= 0)
        tok_f = torch.where(has_forced, state.forced, 0)
        write_pos = state.seq_len.clamp(0, seq_buf - 1)
        seq = torch.where((slots == write_pos[:, None]) & has_forced[:, None],
                          tok_f[:, None], state.seq)
        seq_len = state.seq_len + has_forced.int()
        bar_count = state.bar_count + (has_forced & (tok_f == BAR_ID)).int()
        forced = torch.where(has_forced, -1, state.forced)

        # ---- forward over each row's last token -----------------------
        last = _gather_row(seq, seq_len - 1)
        new_logits_full, k_self, v_self = decode_step(
            self.model, self.cfg, self.rel, last, state.cache.view(view))
        commit_mask = active & (has_forced | (~state.no_seq & ~state.first_loop))
        # a commit against a full cache would drop the newest K/V while the
        # length keeps counting: flag the row failed (against the FULL
        # capacity; a narrower view never holds a full row)
        overflow = commit_mask & (state.cache.length >= self.capacity)
        cache = commit(state.cache, k_self, v_self, commit_mask)
        logits = torch.where((active & ~state.no_seq)[:, None],
                             new_logits_full[:, 1:], state.logits)

        phase_b = active & ~has_forced
        no_seq = state.no_seq & ~phase_b
        first_loop = state.first_loop & ~(phase_b & ~state.no_seq)

        # ---- calc_probs (with the in-place temperature quirk) ----------
        if self.temperature != 0:
            logits = torch.where(phase_b[:, None], logits / self.temperature,
                                 logits)
            probs_tail = torch.softmax(logits, dim=-1)
        else:  # one-hot of the argmax
            probs_tail = torch.zeros_like(logits).scatter_(
                1, torch.argmax(logits, dim=-1, keepdim=True), 1.0)
        probs = torch.nn.functional.pad(probs_tail, (1, 0))  # id == index

        incomplete_filled = state.incomplete_filled | (phase_b & (bar_count > 1))

        # ---- sequence-based teaches ------------------------------------
        last2 = _gather_row(seq, seq_len - 2)
        remnant = state.chord_rem > 0
        pos_fit = (last2 == BAR_ID) & (last == _POSITION)
        cur_pos = _gather_row(chord_pos, state.chord_head)
        cur_tok = _gather_row(chord_tok, state.chord_head)
        cur_inter = _gather_row(inter_flag, state.chord_head)

        c1 = phase_b & incomplete_filled & (last == BAR_ID)
        base = phase_b & ~c1 & remnant & incomplete_filled
        c2 = base & length_fit & pos_fit
        c3 = base & ~length_fit & (
            pos_fit | (~pos_fit & (last == cur_pos) & cur_inter))
        teach_chord = c2 | c3

        # ---- sampling ----------------------------------------------------
        samp = phase_b & ~c1 & ~teach_chord
        masked = masked_probs(probs, state.banned, self.top_k)
        total = masked.sum(dim=-1)
        fail_now = samp & ((total <= 0) | ~torch.isfinite(total))
        draw = draw_categorical(masked, generator)
        token = torch.where(fail_now, 0, draw).int()
        samp_ok = samp & ~fail_now

        # ---- token-based teaches -----------------------------------------
        d1 = samp_ok & remnant & cur_inter & (
            ((cur_pos < token)
             & (token < _POSITION + DEFAULT_POSITION_RESOLUTION))
            | (token == BAR_ID))
        d2 = samp_ok & ~d1 & (token >= _CHORD_START) & (token <= _CHORD_END)
        d3 = samp_ok & ~d1 & ~d2 & remnant & (token == EOS_ID)
        d4 = samp_ok & ~d1 & ~d2 & ~d3 & ~remnant & (token == BAR_ID)
        do_append = samp_ok & ~d1 & ~d2 & ~d3 & ~d4

        # ---- state updates -------------------------------------------------
        remnant_tok = torch.where(cur_inter, cur_pos, BAR_ID)
        forced = torch.where(c1, _POSITION, forced)
        forced = torch.where(teach_chord, cur_tok, forced)
        forced = torch.where(d1, cur_pos, forced)
        forced = torch.where(d3, remnant_tok, forced)
        forced = torch.where(d4, EOS_ID, forced)

        clear_ban = teach_chord | d1
        banned = state.banned & ~clear_ban[:, None]
        tok_l = token.long()[:, None]
        banned.scatter_(1, tok_l, banned.gather(1, tok_l) | d2[:, None])
        no_seq = no_seq | d2

        chord_head = state.chord_head + teach_chord.int()
        chord_rem = state.chord_rem - teach_chord.int()

        write_pos = seq_len.clamp(0, seq_buf - 1)
        seq = torch.where((slots == write_pos[:, None]) & do_append[:, None],
                          token[:, None], seq)
        seq_len = seq_len + do_append.int()
        bar_count = bar_count + (do_append & (token == BAR_ID)).int()

        new_last = _gather_row(seq, seq_len - 1)
        done = state.done | (active & (new_last == EOS_ID)) | (seq_len >= row_cap)
        failed = state.failed | fail_now | overflow
        for buf, new in ((state.seq, seq), (state.seq_len, seq_len),
                         (state.cache.length, cache.length),
                         (state.logits, logits), (state.forced, forced),
                         (state.banned, banned), (state.no_seq, no_seq),
                         (state.first_loop, first_loop),
                         (state.chord_head, chord_head),
                         (state.chord_rem, chord_rem),
                         (state.bar_count, bar_count),
                         (state.incomplete_filled, incomplete_filled),
                         (state.done, done), (state.failed, failed)):
            buf.copy_(new)

    def _capture(self) -> None:
        """One CUDA graph of ``step`` per cache view, after one eager
        warm-up step per view on the capture stream (cuBLAS workspaces and
        lazily loaded modules are made there, outside any capture).  The
        steps run on whatever the buffers hold: every call resets them."""
        t0 = time.perf_counter()
        gen = torch.Generator(device=self.device)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            for view in self.caps:
                self.step(gen, view)
                self.capture_steps += 1
        torch.cuda.current_stream(self.device).wait_stream(stream)
        pool = torch.cuda.graph_pool_handle()
        graphs = {}
        for view in self.caps:
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(gen)
            with _build.captured_launches() as launches:
                with torch.cuda.graph(graph, pool=pool, stream=stream):
                    self.step(gen, view)
            graphs[view] = (graph, launches)
        torch.cuda.synchronize(self.device)
        self._graphs, self._generator = graphs, gen
        self.capture_seconds += time.perf_counter() - t0

    def _reset(self, primer, encoded_meta_last, chord_tok, chord_pos,
               inter_flag, chord_count, length_fit, incomplete,
               row_cap) -> None:
        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a)).to(self.device, dtype)

        state, t = self.state, self.primer.shape[1]
        state.cache.k.zero_()
        state.cache.v.zero_()
        self.primer.copy_(dev(primer, torch.long))
        cache = prefill(self.model, self.cfg, self.primer, state.cache)
        state.cache.length.copy_(cache.length)
        state.seq.zero_()
        state.seq[:, :t] = self.primer
        state.seq[:, t] = dev(encoded_meta_last, torch.int32)
        state.seq_len.fill_(t + 1)
        state.logits.zero_()
        state.forced.fill_(-1)
        state.banned.zero_()
        state.no_seq.zero_()
        state.first_loop.fill_(True)
        state.chord_head.zero_()
        state.chord_rem.copy_(dev(chord_count, torch.int32))
        state.bar_count.zero_()
        state.incomplete_filled.copy_(~dev(incomplete, torch.bool))
        state.done.zero_()
        state.failed.zero_()
        for buf, a in zip(self.extras, (chord_tok, chord_pos, inter_flag,
                                        length_fit, row_cap)):
            buf.copy_(dev(a, buf.dtype))

    @torch.inference_mode()
    def __call__(self, primer, encoded_meta_last, chord_tok, chord_pos,
                 inter_flag, chord_count, length_fit, incomplete, generator,
                 row_cap) -> SamplerState:
        """primer: [G, 11] ([pad]+meta[:10]); encoded_meta_last: [G] the
        11th meta token; chord_*: [G, C] padded schedules; chord_count: [G];
        incomplete: [G] bool (num_measures % 4 != 0); row_cap: [G] per-row
        sequence-length terminator.  Arrays may be numpy; they are copied
        into the episode's buffers on the model's device."""
        g_dim, t = np.shape(primer)
        c_dim = np.shape(chord_tok)[1]
        if self.state is None:
            self._allocate(g_dim, c_dim, t)
        else:
            made = (*self.primer.shape, self.extras[0].shape[1])
            if (g_dim, t, c_dim) != made:
                raise ValueError(
                    f"episode made for G={made[0]}, T={made[1]}, C={made[2]}; "
                    f"got G={g_dim}, T={t}, C={c_dim}")
        if self.graphs and not self._graphs:
            self._capture()
        self._reset(primer, encoded_meta_last, chord_tok, chord_pos,
                    inter_flag, chord_count, length_fit, incomplete, row_cap)
        state = self.state
        if self.graphs:
            self._generator.set_state(generator.get_state())
        for it in range(self.gen_len):
            if it and it % POLL_EVERY == 0 and \
                    bool((state.done | state.failed).all()):
                break
            # lengths start at t and grow by <= 1 per step
            view = next(c for c in self.caps
                        if t + it < c or c == self.capacity)
            if self.graphs:
                graph, launches = self._graphs[view]
                graph.replay()
                _build.add_launches(launches)
            else:
                self.step(generator, view)
            self.steps += 1
        if self.graphs:
            generator.set_state(self._generator.get_state())
        return state


def _schedule_arrays(inputs: List, chord_cap: int):
    """Pack each input's chord schedule into padded arrays."""
    g_dim = len(inputs)
    tok = np.zeros((g_dim, chord_cap), dtype=np.int32)
    pos = np.zeros((g_dim, chord_cap), dtype=np.int32)
    inter = np.zeros((g_dim, chord_cap), dtype=bool)
    count = np.zeros((g_dim,), dtype=np.int32)
    fit = np.zeros((g_dim,), dtype=bool)
    measures = np.zeros((g_dim,), dtype=np.float32)
    incomplete = np.zeros((g_dim,), dtype=bool)
    for g, inp in enumerate(inputs):
        comps = inp.chord_token_components
        ct, cp = comps["chord_token"], comps["chord_position"]
        n = len(ct)
        tok[g, :n] = ct
        pos[g, :n] = cp
        inter[g, :n] = [p != _POSITION for p in cp]
        count[g] = n
        fit[g] = n == int(inp.num_measures // 4 * 4)
        measures[g] = inp.num_measures
        incomplete[g] = inp.num_measures % 4 != 0
    return tok, pos, inter, count, fit, measures, incomplete


def _check_shared_sampling(inputs: List) -> None:
    if len({(i.temperature, i.top_k) for i in inputs}) != 1:
        raise ValueError("all rows of a batch must share temperature/top_k")


def build_episode(model, cfg: ModelConfig, icfg: InferenceConfig,
                  inputs: List, capacity: Optional[int] = None,
                  chord_cap: Optional[int] = None, graphs: bool = True):
    """(episode, chord_cap) for a batch of inputs sharing temperature and
    top_k.  The default capacity is the generation budget rounded up to a
    multiple of 128, but never past ``memory_length`` (then rounded down):
    the reference attends to at most memory_length context tokens, and a
    row that outgrows the capacity is flagged failed.  ``graphs=False``
    steps the episode eagerly on a CUDA device too."""
    _check_shared_sampling(inputs)
    if capacity is None:
        capacity = min(icfg.memory_length, icfg.generation_length + 16)
        up = -(-capacity // 128) * 128
        if up > icfg.memory_length and icfg.memory_length >= 128:
            capacity = (icfg.memory_length // 128) * 128
        else:
            capacity = up
    seq_buf = icfg.generation_length + 16
    chord_cap = chord_cap or max(
        8, max(len(i.chord_token_components["chord_token"]) for i in inputs))
    episode = Episode(
        model, cfg, icfg, capacity=capacity, seq_buf=seq_buf,
        temperature=inputs[0].temperature, top_k=inputs[0].top_k,
        graphs=graphs)
    return episode, chord_cap


def cached_episode(model, cfg: ModelConfig, icfg: InferenceConfig,
                   inputs: List, cache: Optional[dict] = None, *,
                   graphs: bool = True):
    """``build_episode`` with an optional cross-request cache (serving).

    A fresh episode captures its graphs again; a long-lived process (the
    ``MidiGenerationPipeline``, ``generate --serve``) passes a dict here and
    captures once per (batch width, temperature, top_k, chord-capacity
    bucket of 8): prompts whose chord counts share a bucket share the
    episode (the schedule cursor never reaches the padding)."""
    # the key carries row 0's sampling parameters, so a mixed batch must
    # fail BEFORE the lookup: a warm hit would sample every row with row
    # 0's temperature/top_k
    _check_shared_sampling(inputs)
    chord_cap = _chord_cap(inputs)
    if cache is None:
        return build_episode(model, cfg, icfg, inputs, chord_cap=chord_cap,
                             graphs=graphs)
    key = (len(inputs), inputs[0].temperature, inputs[0].top_k, chord_cap)
    if key not in cache:
        cache[key] = build_episode(model, cfg, icfg, inputs,
                                   chord_cap=chord_cap, graphs=graphs)
    return cache[key]


def run_episode(episode, chord_cap: int, inputs: List,
                encoded_metas: List[List[int]], generator: torch.Generator,
                row_cap: Optional[np.ndarray] = None):
    """One batched episode over heterogeneous prompts; returns (sequences as
    python lists, failed flags, chord_rem) as host values (copies: the
    episode reuses its buffers)."""
    g_dim = len(inputs)
    tok, pos, inter, count, fit, _, incomplete = _schedule_arrays(
        inputs, chord_cap)
    primer = np.array([[0] + list(m[:-1]) for m in encoded_metas],
                      dtype=np.int32)
    meta_last = np.array([m[-1] for m in encoded_metas], dtype=np.int32)
    if row_cap is None:
        row_cap = np.full((g_dim,), 2 ** 30, dtype=np.int32)
    state = episode(primer, meta_last, tok, pos, inter, count, fit,
                    incomplete, generator, row_cap)
    seqs, lens, failed, rem = (x.cpu().numpy().copy() for x in (
        state.seq, state.seq_len, state.failed, state.chord_rem))
    out = [list(map(int, seqs[g, :lens[g]])) for g in range(g_dim)]
    return out, failed, rem


def _validate(inp, seq: List[int], rem: int) -> bool:
    """Host-side sequence validation (midi_inferrer.py:146-168,322-336)."""
    chord_length = len(inp.chord_token_components["chord_token"])
    num_bars = seq.count(BAR_ID)
    num_chord = sum(1 for t in seq if _CHORD_START <= t <= _CHORD_END)
    if rem != 0:
        return False
    if num_bars != int(math.ceil(inp.num_measures)):
        return False
    if num_chord != chord_length:
        return False
    return validate_generated_sequence(seq)


def _chord_cap(inputs: List) -> int:
    """Chord-schedule padding bucketed to a multiple of 8 (as the reference's
    episode cache does; padding beyond the schedule is never read)."""
    n = max(len(i.chord_token_components["chord_token"]) for i in inputs)
    return max(8, -(-n // 8) * 8)


def _generator(model, seed: int) -> torch.Generator:
    gen = torch.Generator(device=model.embedding.device)
    gen.manual_seed(seed)
    return gen


def execute(model, cfg: ModelConfig, icfg: InferenceConfig, input_data,
            encoded_meta: List[int], seed: int = 0, validate: bool = True,
            max_rounds: Optional[int] = 20,
            episode_cache: Optional[dict] = None) -> List[List[int]]:
    """Generate ``num_generate`` valid sequences for one prompt, batching all
    attempts of a round.  Gives up after ``max_rounds`` rounds (None: retry
    forever, the reference's behavior).  ``episode_cache``: see
    ``cached_episode``."""
    generator = _generator(model, seed)
    want = input_data.num_generate
    batch = [input_data] * want
    episode, chord_cap = cached_episode(model, cfg, icfg, batch,
                                        episode_cache)
    sequences: List[List[int]] = []
    rounds = 0
    while len(sequences) < want:
        rounds += 1
        if max_rounds is not None and rounds > max_rounds:
            raise RuntimeError("generation repeatedly failed validation")
        outs, failed, rems = run_episode(
            episode, chord_cap, batch, [encoded_meta] * want, generator)
        for g, seq in enumerate(outs):
            if failed[g]:
                logger.error("Sampling error in row %d", g)
                continue
            if validate and not _validate(input_data, seq, int(rems[g])):
                logger.error("Invalid sequence in row %d", g)
                continue
            sequences.append(seq)
            if len(sequences) == want:
                break
    return sequences


def execute_batch(model, cfg: ModelConfig, icfg: InferenceConfig,
                  inputs: List, encoded_metas: List[List[int]],
                  seed: int = 0, max_rounds: Optional[int] = 20,
                  validate: bool = True,
                  episode_cache: Optional[dict] = None):
    """Multi-prompt batched generation: one sequence per input row,
    retrying only the rows that failed.  ``episode_cache``: see
    ``cached_episode``."""
    generator = _generator(model, seed)
    g_dim = len(inputs)
    episode, chord_cap = cached_episode(model, cfg, icfg, inputs,
                                        episode_cache)
    results: List[Optional[List[int]]] = [None] * g_dim
    pending = list(range(g_dim))
    rounds = 0
    while pending and (max_rounds is None or rounds < max_rounds):
        rounds += 1
        # keep the batch width constant (pad with retried rows)
        slots = (pending * ((g_dim + len(pending) - 1) // len(pending)))[:g_dim]
        outs, failed, rems = run_episode(
            episode, chord_cap, [inputs[i] for i in slots],
            [encoded_metas[i] for i in slots], generator)
        for slot, i in enumerate(slots):
            if results[i] is not None:
                continue
            seq = outs[slot]
            ok = not failed[slot] and (
                not validate or _validate(inputs[i], seq, int(rems[slot])))
            if ok:
                results[i] = seq
        pending = [i for i in pending if results[i] is None]
    if pending:
        raise RuntimeError(f"rows {pending} failed after {max_rounds} rounds")
    return results
