"""Typed, frozen configuration (reference: commu/model/config_helper.py:4-80).

Same field names and default values as the reference's yacs nodes, expressed as
frozen dataclasses.  Hyperparameters are code, not flags — the train CLI takes
only data/work dirs, exactly like the reference (train.py:57-70).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    num_layers: int = 6
    num_heads: int = 10
    units: int = 500
    inner_size: int = 1000
    dropout: float = 0.1
    attention_dropout: float = 0.1
    clamp_len: int = -1
    same_length: bool = False
    # "pallas" and "auto": the kernel path (the hand-written CUDA kernels
    # on a CUDA device, their plain PyTorch versions on the CPU); "xla": the
    # unfused einsum/softmax path in plain torch, which clamp_len > 0 also
    # selects. Numerics match either way.
    attn_impl: str = "auto"


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 256
    batch_chunk: int = 4
    tgt_length: int = 128
    mem_length: int = 1024
    seed: int = 1111
    lr: float = 0.004
    lr_min: float = 0.0001
    warmup_step: int = 100
    clip: float = 1.0
    max_step: int = 20000
    log_interval: int = 100
    eval_interval: int = 1000
    weight_decay: float = 0.0


@dataclass(frozen=True)
class InitializerConfig:
    base_init: float = 0.01
    embed_init: float = 0.01


@dataclass(frozen=True)
class EvaluateConfig:
    batch_size: int = 10
    tgt_length: int = 128
    mem_length: int = 2048


@dataclass(frozen=True)
class TrainingConfig:
    """The full training-side namespace (MODEL/TRAIN/INITIALIZER/EVALUATE)."""

    model: ModelConfig = ModelConfig()
    train: TrainConfig = TrainConfig()
    initializer: InitializerConfig = InitializerConfig()
    evaluate: EvaluateConfig = EvaluateConfig()

    def replace(self, **kwargs) -> "TrainingConfig":
        return dataclasses.replace(self, **kwargs)

    def to_yaml(self) -> str:
        """Work-dir config snapshot (reference writes str(cfg) to config.yml)."""
        lines = []
        for section_name, section in (
            ("MODEL", self.model), ("TRAIN", self.train),
            ("INITIALIZER", self.initializer), ("EVALUATE", self.evaluate),
        ):
            lines.append(f"{section_name}:")
            for field in dataclasses.fields(section):
                lines.append(f"  {field.name}: {getattr(section, field.name)}")
        return "\n".join(lines) + "\n"


@dataclass(frozen=True)
class InferenceConfig:
    """Generation-side namespace (reference: config_helper.py:61-80)."""

    memory_length: int = 4146
    device: str = "tpu"
    threshold: float = 32.0       # top-k
    temperature: float = 0.95
    generation_length: int = 4096


def _coerce(field: dataclasses.Field, raw: str):
    raw = raw.strip()
    if field.type in ("bool", bool):
        return raw in ("True", "true", "1")
    if field.type in ("int", int):
        return int(raw)
    if field.type in ("float", float):
        return float(raw)
    return raw


def load_config_snapshot(path) -> TrainingConfig:
    """Parse a work-dir ``config.yml`` snapshot back into a TrainingConfig.

    The reference's model initializer locates the sibling config.yml but never
    parses it (model_initializer.py:25-34) — generation silently assumes
    default hyperparameters.  We close that hole: a checkpoint travels with
    the exact model shape it was trained with.
    """
    sections = {"MODEL": {}, "TRAIN": {}, "INITIALIZER": {}, "EVALUATE": {}}
    current = None
    with open(path) as fh:
        for line in fh:
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            if not line.startswith(" ") and line.rstrip().endswith(":"):
                current = line.strip()[:-1]
                continue
            if current in sections and ":" in line:
                key, _, raw = line.strip().partition(":")
                sections[current][key.strip()] = raw
    cfg = TrainingConfig()
    out = {}
    for name, section in (("model", cfg.model), ("train", cfg.train),
                          ("initializer", cfg.initializer),
                          ("evaluate", cfg.evaluate)):
        fields = {f.name: f for f in dataclasses.fields(section)}
        kwargs = {k: _coerce(fields[k], v)
                  for k, v in sections[name.upper()].items() if k in fields}
        out[name] = dataclasses.replace(section, **kwargs)
    return TrainingConfig(**out)


def get_default_cfg_training() -> TrainingConfig:
    return TrainingConfig()


def get_default_cfg_inference() -> InferenceConfig:
    return InferenceConfig()
