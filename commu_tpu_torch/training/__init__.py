"""Training and evaluation: the train and eval steps, the learning-rate
schedule, checkpoints, and ``Trainer`` (train, evaluate, final_test,
resume)."""
from ..config import EvaluateConfig, TrainConfig, TrainingConfig

from .checkpoint import CheckpointManager
from .loop import Trainer
from .step import (make_eval_step, make_optimizer, make_train_step,
                   masked_chunk_loss)

__all__ = ["CheckpointManager", "EvaluateConfig", "TrainConfig", "Trainer",
           "TrainingConfig", "make_eval_step", "make_optimizer",
           "make_train_step", "masked_chunk_loss"]
