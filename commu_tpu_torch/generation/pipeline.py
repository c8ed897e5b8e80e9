"""Generation pipeline facade: checkpoint load, meta encoding, the sampler
(the batched device sampler, or the host-parity loop with
``sampler="host"``), MIDI postprocessing.

PyTorch counterpart of ``commu_tpu/generation/pipeline.py``.  It reads
reference-format ``.pt`` checkpoints; an Orbax directory written by the JAX
trainer has to be exported to ``.pt`` first.
"""
from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import List, Optional

import torch

from ..config import (InferenceConfig, ModelConfig,
                              get_default_cfg_inference, load_config_snapshot)
from ..vocab.event_tokens import VOCAB_SIZE
from ..vocab.meta_codec import encode_meta

from ..models.convert import load_reference_pt
from ..models.transformer_xl import TransformerXL
from . import device_sampler, host_sampler, postprocess
from .container import GenerationInput

logger = logging.getLogger("ComMU")


def _model_cfg_for_checkpoint(checkpoint_dir: str) -> ModelConfig:
    """Model shape for a checkpoint: the sibling ``config.yml`` if one
    exists (written by the JAX trainer), else the reference defaults."""
    path = Path(checkpoint_dir)
    base = path.parent if path.suffix == ".pt" or path.is_dir() else path
    snapshot = base / "config.yml"
    if snapshot.is_file():
        model_cfg = load_config_snapshot(snapshot).model
        logger.info("model config from %s", snapshot)
        return dataclasses.replace(model_cfg, same_length=True)
    return ModelConfig(same_length=True)


def load_model(checkpoint_dir: str, model_cfg: ModelConfig,
               device, dtype=torch.float32) -> TransformerXL:
    """The port's model with a reference-format ``.pt`` checkpoint's
    weights, in eval mode on ``device`` in ``dtype``."""
    path = Path(checkpoint_dir)
    if path.suffix != ".pt":
        raise ValueError(
            f"{checkpoint_dir}: only reference-format .pt checkpoints can be "
            "read here (an Orbax directory needs orbax); export one with "
            "commu_tpu.training.checkpoint.export_torch(params, 'model.pt', "
            "cfg=model_cfg) and pass the .pt file")
    model = TransformerXL(VOCAB_SIZE, model_cfg)
    missing, _ = model.load_state_dict(load_reference_pt(path), strict=False)
    if missing:
        raise KeyError(f"{checkpoint_dir}: missing parameters {missing}")
    return model.to(device=device, dtype=dtype).eval()


class MidiGenerationPipeline:
    """``sampler``: "jit", the batched device sampler
    (``device_sampler``), or "host", the reference-parity loop
    (``host_sampler``)."""

    def __init__(self, checkpoint_dir: str,
                 model_cfg: Optional[ModelConfig] = None,
                 inference_cfg: Optional[InferenceConfig] = None,
                 decode_dtype=torch.float32, device="cuda",
                 sampler: str = "jit"):
        if sampler not in ("jit", "host"):
            raise ValueError(f"sampler {sampler!r}: expected jit or host")
        self.model_cfg = model_cfg or _model_cfg_for_checkpoint(checkpoint_dir)
        self.inference_cfg = inference_cfg or get_default_cfg_inference()
        self.model = load_model(checkpoint_dir, self.model_cfg,
                                torch.device(device), decode_dtype)
        self.sampler = sampler
        # episode reuse across calls (the serving path): keyed by (batch
        # width, temperature, top_k, chord-cap bucket), graphs captured once
        # per key; see device_sampler.cached_episode
        self.episode_cache: dict = {}
        self.host_steps = 0  # the host loop's forwards so far

    def episode_totals(self) -> dict:
        """Decode steps run (the host loop's forwards included), warm-up
        steps and seconds spent capturing, over every cached episode so far
        (a response takes the difference)."""
        episodes = [episode for episode, _ in self.episode_cache.values()]
        return {"decode_steps": sum(e.steps for e in episodes)
                + self.host_steps,
                "capture_steps": sum(e.capture_steps for e in episodes),
                "capture_s": sum(e.capture_seconds for e in episodes)}

    def encode_input_meta(self, input_data: GenerationInput) -> List[int]:
        return encode_meta(input_data.midi_meta())

    def generate_sequences(self, input_data: GenerationInput, seed: int = 0,
                           validate: bool = True) -> List[List[int]]:
        if self.sampler == "host":
            engine = host_sampler.InferenceEngine(
                self.model, self.model_cfg, self.inference_cfg)
            try:
                return host_sampler.execute(
                    engine, input_data, self.encode_input_meta(input_data),
                    seed, validate=validate)
            finally:
                self.host_steps += engine.steps
        return device_sampler.execute(
            self.model, self.model_cfg, self.inference_cfg, input_data,
            self.encode_input_meta(input_data), seed, validate=validate,
            episode_cache=self.episode_cache)

    def run(self, input_data: GenerationInput, seed: int = 0,
            validate: bool = True) -> Path:
        sequences = self.generate_sequences(input_data, seed, validate=validate)
        out = postprocess.write_sequences(input_data, sequences)
        logger.info("generated %d sequences -> %s", len(sequences), out)
        return out
