"""Learning-rate schedule, after ``commu_tpu/training/schedule.py``.

Noam-style: linear warmup over ``warmup_step`` updates, then inverse-sqrt
decay floored at ``lr_min``; the base rate is ``lr / num_devices`` (the
reference's ``local_lr``).  ``multiplier(count)`` is the factor a
``torch.optim.lr_scheduler.LambdaLR`` applies at update count ``count``: 0 at
count 0 when ``warmup_step > 0``, as the reference's LambdaLR gives its
first optimizer step.
"""
from __future__ import annotations

import math

from ..config import TrainConfig


def base_lr(cfg: TrainConfig, num_devices: int = 1) -> float:
    return cfg.lr / num_devices


def multiplier(cfg: TrainConfig, count: int) -> float:
    """The schedule's factor on ``base_lr`` at update count ``count``."""
    warmup = cfg.warmup_step
    floor = cfg.lr_min / cfg.lr
    if warmup == 0:
        return 1.0 if count == 0 else max(0.0, floor)
    if count > warmup:
        return max(math.sqrt(warmup) / math.sqrt(max(count, 1)), floor)
    return count / warmup


def lr_at(cfg: TrainConfig, count: int, num_devices: int = 1) -> float:
    """The learning rate applied by the update at count ``count``."""
    return base_lr(cfg, num_devices) * multiplier(cfg, count)
