"""Host-parity sampling loop (``generate --sampler host``).

PyTorch counterpart of ``commu_tpu/generation/host_sampler.py``, the
structural replica of the reference's ``InferenceTask``: a Python loop
drives one token per step, the ``TeacherForcer`` decides forced tokens,
bans and the early exit, and each forward is the port's KV-cache
``decode_step`` (batch 1, run eagerly) in place of a full-window re-encode.
The memory-commit rules are the reference's, quirks included:

- the first sampling forward does NOT commit, so the last meta token never
  enters the cache;
- a forced token's forward commits, and the next iteration's forward
  commits the SAME token again;
- after a banned chord token the stale logits are reused without a
  forward, and the temperature divides them in place once more.

On a CUDA device the prefill launches the no-memory attention forward and
the FFN forward kernels, and every committed step one ``cache_append``.
Sampling draws from a ``numpy.random.Generator``, as the reference's
parity path does; ``device_sampler`` is the batched serving path.
"""
from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np
import torch

from ..config import InferenceConfig, ModelConfig
from ..vocab.event_tokens import BAR_ID, EOS_ID

from ..models.decode import commit, decode_step, init_cache, precompute_rel, prefill
from .teacher import TeacherForcer, validate_generated_sequence

logger = logging.getLogger("ComMU")


class SamplingError(RuntimeError):
    pass


def sample_from_logits(logits: np.ndarray, temperature: float, top_k: int,
                       wrong_tokens: List[int], rng: np.random.Generator,
                       return_probs: bool = False):
    """Temperature -> softmax -> left-pad -> top-k -> ban -> renorm -> draw.
    ``logits`` excludes token 0.

    QUIRK: the reference divides the logits by the temperature IN PLACE,
    so stale logits reused after a banned chord token are tempered again;
    ``logits`` is mutated here to reproduce that.
    """
    if temperature == 0:
        probs = np.zeros_like(logits, dtype=np.float64)
        probs[int(np.argmax(logits))] = 1.0
    else:
        logits /= temperature  # in place on purpose (see docstring)
        shifted = logits.astype(np.float64) - logits.max()
        e = np.exp(shifted)
        probs = e / e.sum()
    probs = np.concatenate([[0.0], probs])  # token id == index

    top_idx = np.argsort(-probs, kind="stable")[:top_k]
    mask = np.zeros_like(probs)
    mask[top_idx] = 1.0
    for w in wrong_tokens:
        mask[w] = 0.0
    probs = probs * mask
    total = probs.sum()
    if total <= 0 or not np.isfinite(total):
        raise SamplingError("all candidate tokens masked")
    probs = probs / total
    token = int(rng.choice(len(probs), p=probs))
    return (token, probs) if return_probs else token


class InferenceEngine:
    """Prefill and one-token steps over the port's decode path, batch 1,
    on the model's device.  The cache holds ``capacity`` slots (default
    ``min(memory_length, generation_length + 16)``) in float32, as the
    reference's parity path keeps it; ``steps`` counts the forwards."""

    def __init__(self, model, model_cfg: ModelConfig,
                 inference_cfg: Optional[InferenceConfig] = None,
                 capacity: Optional[int] = None):
        self.model = model
        self.cfg = model_cfg
        self.inference_cfg = inference_cfg or InferenceConfig()
        gen_len = self.inference_cfg.generation_length
        self.capacity = capacity or min(self.inference_cfg.memory_length,
                                        gen_len + 16)
        self.device = model.embedding.device
        self.rel = precompute_rel(model, model_cfg, self.capacity)
        self.steps = 0

    @torch.inference_mode()
    def prime(self, encoded_meta: List[int]):
        """The one-shot prefill of [pad] + meta[:10]; -> (seq, cache)."""
        primer = torch.tensor([[0] + list(encoded_meta[:-1])],
                              dtype=torch.long, device=self.device)
        cache = init_cache(self.cfg, 1, self.capacity, device=self.device)
        cache = prefill(self.model, self.cfg, primer, cache)
        return [0] + [int(t) for t in encoded_meta], cache

    @torch.inference_mode()
    def forward_last(self, seq: List[int], cache, *, advance: bool):
        """The logits after ``seq[-1]`` (token 0 stripped, a writable f32
        numpy array: the sampler divides it in place) and the cache, with
        that token's K/V appended where ``advance``."""
        tok = torch.tensor([seq[-1]], dtype=torch.long, device=self.device)
        logits, k_self, v_self = decode_step(self.model, self.cfg, self.rel,
                                             tok, cache)
        if advance:
            cache = commit(cache, k_self, v_self,
                           torch.ones(1, dtype=torch.bool, device=self.device))
        self.steps += 1
        return logits[0, 1:].float().cpu().numpy().copy(), cache


def generate_sequence(engine: InferenceEngine, input_data, seq: List[int],
                      cache, rng: np.random.Generator) -> Optional[List[int]]:
    """One sampling episode; None where sampling or the teacher's final
    validation fails."""
    teacher = TeacherForcer(input_data)
    logits = None
    first_loop = True
    for _ in range(engine.inference_cfg.generation_length):
        if seq[-1] == EOS_ID:
            break

        if teacher.next_tokens_forced:
            seq.append(teacher.next_tokens_forced.pop(0))
            logits, cache = engine.forward_last(seq, cache, advance=True)
            continue

        if teacher.no_sequence_appended:
            if logits is None:
                raise SamplingError("stale logits reused before any forward")
            teacher.no_sequence_appended = False
        elif first_loop:
            logits, _ = engine.forward_last(seq, cache, advance=False)
            first_loop = False
        else:
            logits, cache = engine.forward_last(seq, cache, advance=True)

        if not teacher.incomplete_filled:
            teacher.incomplete_filled = seq.count(BAR_ID) > 1

        if teacher.check_first_position(seq):
            teacher.teach_first_position()
            continue
        if teacher.check_one_chord_per_bar_case(seq):
            teacher.teach_chord_token()
            continue
        if teacher.check_mul_chord_per_bar_case(seq):
            teacher.teach_chord_token()
            continue

        try:
            token = sample_from_logits(
                logits, input_data.temperature, input_data.top_k,
                teacher.wrong_tokens, rng)
        except SamplingError as e:
            logger.error("Sampling Error: %s", e)
            return None

        if teacher.check_chord_position_passed(token):
            teacher.teach_chord_position()
            continue
        if teacher.check_wrong_chord_token_generated(token):
            teacher.teach_wrong_chord_token(token)
            continue
        if teacher.check_wrong_eos_generated(token):
            teacher.teach_remnant_chord()
            continue
        if teacher.check_wrong_bar_token_generated(token):
            teacher.teach_eos()
            continue

        seq.append(token)

    try:
        teacher.validate_teacher_forced_sequence(seq)
    except ValueError as error:
        logger.error("%s", error)
        return None
    return seq


def execute(engine: InferenceEngine, input_data, encoded_meta: List[int],
            seed: int = 0, validate: bool = True,
            max_attempts_per_sequence: Optional[int] = 20) -> List[List[int]]:
    """Generate until ``num_generate`` valid sequences, from one
    ``numpy.random.default_rng(seed)``.  The reference retries forever;
    this raises after ``max_attempts_per_sequence * num_generate`` attempts
    (None: unbounded).  Without ``validate`` a failed episode keeps what it
    produced."""
    rng = np.random.default_rng(seed)
    sequences: List[List[int]] = []
    attempts = 0
    while len(sequences) != input_data.num_generate:
        attempts += 1
        if (max_attempts_per_sequence is not None and
                attempts > max_attempts_per_sequence * input_data.num_generate):
            raise RuntimeError("generation repeatedly failed validation")
        logger.info("Generating the idx: %d", len(sequences) + 1)
        seq, cache = engine.prime(encoded_meta)
        full = generate_sequence(engine, input_data, seq, cache, rng)
        if validate:
            if full is None:
                continue
            if not validate_generated_sequence(full):
                logger.error("Empty sequence generated")
                continue
        elif full is None:
            full = seq  # lenient mode: keep whatever was produced
        sequences.append(full)
    return sequences
