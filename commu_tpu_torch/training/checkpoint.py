"""Checkpoints: the best/last policy with real resume, in the reference's
``.pt`` layout.

PyTorch counterpart of ``commu_tpu/training/checkpoint.py``.  The files are
``checkpoint_{last,best}.pt`` under the work dir, with the keys the
reference writes (and ``commu_tpu.training.checkpoint.export_torch``):
``model`` (the state dict, on the CPU), ``optimizer`` and ``scheduler`` (the
real torch state dicts, so resume restores Adam's moments and the schedule
position), ``train_step``, ``best_val_nll``, ``vocab`` and ``amp``.  A
``model`` entry loads anywhere a reference checkpoint does: the JAX
package's ``import_torch`` and ``python -m commu_tpu_torch.generate``.
"""
from __future__ import annotations

from pathlib import Path

import torch


class CheckpointManager:
    """best/last checkpoints under ``work_dir``."""

    def __init__(self, work_dir):
        self.work_dir = Path(work_dir)
        self.work_dir.mkdir(parents=True, exist_ok=True)

    def path(self, name: str) -> Path:
        return self.work_dir / f"{name}.pt"

    def save(self, name: str, model, optimizer, scheduler, step: int,
             best_val_nll: float) -> None:
        blob = {
            "model": {k: v.detach().cpu() for k, v in
                      model.state_dict().items()},
            "optimizer": optimizer.state_dict(),
            "scheduler": scheduler.state_dict(),
            "train_step": int(step),
            "best_val_nll": float(best_val_nll),
            "vocab": None,
            "amp": None,
        }
        tmp = self.path(name).with_suffix(".pt.tmp")
        torch.save(blob, str(tmp))
        tmp.replace(self.path(name))  # a reader never sees half a file

    def save_last(self, *args) -> None:
        self.save("checkpoint_last", *args)

    def save_best(self, *args) -> None:
        self.save("checkpoint_best", *args)

    def restore(self, name: str, model, optimizer=None, scheduler=None
                ) -> tuple[int, float]:
        """Load ``name`` into the model (and the optimizer and scheduler when
        given); returns (train_step, best_val_nll)."""
        device = next(model.parameters()).device
        blob = torch.load(str(self.path(name)), map_location=device,
                          weights_only=False)
        model.load_state_dict(blob["model"])
        if optimizer is not None:
            optimizer.load_state_dict(blob["optimizer"])
        if scheduler is not None:
            scheduler.load_state_dict(blob["scheduler"])
        return int(blob["train_step"]), float(blob["best_val_nll"])

    def has(self, name: str) -> bool:
        return self.path(name).exists()


def write_config_snapshot(work_dir, cfg) -> None:
    """The reference writes its config to work_dir/config.yml; the serving
    path reads it back beside a checkpoint for the model's shape."""
    path = Path(work_dir)
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.yml").write_text(cfg.to_yaml())
