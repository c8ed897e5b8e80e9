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
from typing import Callable, List, Optional

import numpy as np
import torch

from ..config import InferenceConfig, ModelConfig
from ..utils.constants import DEFAULT_POSITION_RESOLUTION
from ..vocab.event_tokens import BAR_ID, EOS_ID, TokenOffset, VOCAB_SIZE

from ..models.decode import (KVCache, commit, decode_step, init_cache,
                             precompute_rel, prefill)
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


def make_episode_fn(model, cfg: ModelConfig, icfg: InferenceConfig, *,
                    capacity: int, seq_buf: int, temperature: float,
                    top_k: int) -> Callable:
    """The episode: (primer, chord schedule, lengths, generator) -> final
    state.  Per-row metadata arrays allow heterogeneous prompts."""
    rel = precompute_rel(model, cfg, capacity)
    gen_len = icfg.generation_length
    caps = _segment_caps(capacity)
    device = model.embedding.device

    def body(state: SamplerState, extras, generator, view: int):
        chord_tok, chord_pos, inter_flag, length_fit, row_cap = extras
        g_dim = state.seq.shape[0]
        slots = torch.arange(seq_buf, device=device)[None, :]
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
            model, cfg, rel, last, state.cache.view(view))
        commit_mask = active & (has_forced | (~state.no_seq & ~state.first_loop))
        # a commit against a full cache would drop the newest K/V while the
        # length keeps counting: flag the row failed (against the FULL
        # capacity; a narrower view never holds a full row)
        overflow = commit_mask & (state.cache.length >= capacity)
        cache = commit(state.cache, k_self, v_self, commit_mask)
        logits = torch.where((active & ~state.no_seq)[:, None],
                             new_logits_full[:, 1:], state.logits)

        phase_b = active & ~has_forced
        no_seq = state.no_seq & ~phase_b
        first_loop = state.first_loop & ~(phase_b & ~state.no_seq)

        # ---- calc_probs (with the in-place temperature quirk) ----------
        if temperature != 0:
            logits = torch.where(phase_b[:, None], logits / temperature, logits)
            probs_tail = torch.softmax(logits, dim=-1)
        else:
            probs_tail = torch.nn.functional.one_hot(
                torch.argmax(logits, dim=-1), logits.shape[1]).to(logits.dtype)
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
        masked = masked_probs(probs, state.banned, top_k)
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
        rows = torch.arange(g_dim, device=device)
        tok_l = token.long()
        banned[rows, tok_l] = banned[rows, tok_l] | d2
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
        return SamplerState(
            seq=seq, seq_len=seq_len, cache=cache, logits=logits,
            forced=forced, banned=banned, no_seq=no_seq, first_loop=first_loop,
            chord_head=chord_head, chord_rem=chord_rem, bar_count=bar_count,
            incomplete_filled=incomplete_filled, done=done, failed=failed)

    @torch.inference_mode()
    def episode(primer, encoded_meta_last, chord_tok, chord_pos, inter_flag,
                chord_count, length_fit, incomplete, generator, row_cap):
        """primer: [G, 11] ([pad]+meta[:10]); encoded_meta_last: [G] the
        11th meta token; chord_*: [G, C] padded schedules; chord_count: [G];
        incomplete: [G] bool (num_measures % 4 != 0); row_cap: [G] per-row
        sequence-length terminator.  Arrays may be numpy; they are moved to
        the model's device."""
        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a), device=device).to(dtype)

        primer = dev(primer, torch.long)
        g_dim, t = primer.shape
        cache = init_cache(cfg, g_dim, capacity, dtype=model.embedding.dtype,
                           device=device)
        cache = prefill(model, cfg, primer, cache)

        seq = torch.zeros((g_dim, seq_buf), dtype=torch.int32, device=device)
        seq[:, :t] = primer.int()
        seq[:, t] = dev(encoded_meta_last, torch.int32)
        state = SamplerState(
            seq=seq,
            seq_len=torch.full((g_dim,), t + 1, dtype=torch.int32,
                               device=device),
            cache=cache,
            logits=torch.zeros((g_dim, VOCAB_SIZE - 1), dtype=torch.float32,
                               device=device),
            forced=torch.full((g_dim,), -1, dtype=torch.int32, device=device),
            banned=torch.zeros((g_dim, VOCAB_SIZE), dtype=torch.bool,
                               device=device),
            no_seq=torch.zeros((g_dim,), dtype=torch.bool, device=device),
            first_loop=torch.ones((g_dim,), dtype=torch.bool, device=device),
            chord_head=torch.zeros((g_dim,), dtype=torch.int32, device=device),
            chord_rem=dev(chord_count, torch.int32),
            bar_count=torch.zeros((g_dim,), dtype=torch.int32, device=device),
            incomplete_filled=~dev(incomplete, torch.bool),
            done=torch.zeros((g_dim,), dtype=torch.bool, device=device),
            failed=torch.zeros((g_dim,), dtype=torch.bool, device=device))
        extras = (dev(chord_tok, torch.int32), dev(chord_pos, torch.int32),
                  dev(inter_flag, torch.bool), dev(length_fit, torch.bool),
                  dev(row_cap, torch.int32))
        for it in range(gen_len):
            if it and it % POLL_EVERY == 0 and \
                    bool((state.done | state.failed).all()):
                break
            # lengths start at t and grow by <= 1 per step
            view = next(c for c in caps if t + it < c or c == capacity)
            state = body(state, extras, generator, view)
        return state

    return episode


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


def build_episode(model, cfg: ModelConfig, icfg: InferenceConfig,
                  inputs: List, capacity: Optional[int] = None,
                  chord_cap: Optional[int] = None):
    """(episode, chord_cap) for a batch of inputs sharing temperature and
    top_k.  The default capacity is the generation budget rounded up to a
    multiple of 128, but never past ``memory_length`` (then rounded down):
    the reference attends to at most memory_length context tokens, and a
    row that outgrows the capacity is flagged failed."""
    if len({(i.temperature, i.top_k) for i in inputs}) != 1:
        raise ValueError("all rows of a batch must share temperature/top_k")
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
    episode = make_episode_fn(
        model, cfg, icfg, capacity=capacity, seq_buf=seq_buf,
        temperature=inputs[0].temperature, top_k=inputs[0].top_k)
    return episode, chord_cap


def run_episode(episode, chord_cap: int, inputs: List,
                encoded_metas: List[List[int]], generator: torch.Generator,
                row_cap: Optional[np.ndarray] = None):
    """One batched episode over heterogeneous prompts; returns (sequences as
    python lists, failed flags, chord_rem) as host values."""
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
    seqs = state.seq.cpu().numpy()
    lens = state.seq_len.cpu().numpy()
    failed = state.failed.cpu().numpy()
    rem = state.chord_rem.cpu().numpy()
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
            max_rounds: Optional[int] = 20) -> List[List[int]]:
    """Generate ``num_generate`` valid sequences for one prompt, batching all
    attempts of a round.  Gives up after ``max_rounds`` rounds (None: retry
    forever, the reference's behavior)."""
    generator = _generator(model, seed)
    want = input_data.num_generate
    batch = [input_data] * want
    episode, chord_cap = build_episode(model, cfg, icfg, batch,
                                       chord_cap=_chord_cap(batch))
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
                  validate: bool = True):
    """Multi-prompt batched generation: one sequence per input row,
    retrying only the rows that failed."""
    generator = _generator(model, seed)
    g_dim = len(inputs)
    episode, chord_cap = build_episode(model, cfg, icfg, inputs,
                                       chord_cap=_chord_cap(inputs))
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
