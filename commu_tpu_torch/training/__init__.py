"""Evaluation: the windowed eval step and the trainer's validation pass."""
from commu_tpu.config import EvaluateConfig, TrainingConfig

from .loop import Trainer
from .step import make_eval_step

__all__ = ["EvaluateConfig", "Trainer", "TrainingConfig", "make_eval_step"]
