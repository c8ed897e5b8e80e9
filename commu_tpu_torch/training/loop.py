"""The trainer's evaluation pass.

PyTorch counterpart of ``commu_tpu/training/loop.py::Trainer`` as far as
``evaluate`` needs it: the dataset (``commu_tpu.data``, which is numpy
only), the model in ``model_dtype`` with f32 parameters and a seeded
initialization, and the eval step.  One device, given explicitly.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from commu_tpu.config import TrainingConfig
from commu_tpu.data.dataset import ComMUDataset
from commu_tpu.vocab.event_tokens import VOCAB_SIZE

from ..models.transformer_xl import TransformerXL, init_memory
from .step import make_eval_step


class Trainer:
    """``data_dir`` holds the reference's ``{input,target}_{split}.npy``.
    Parameters are drawn from ``generator`` (default: seeded with
    ``cfg.train.seed``) on the CPU, so a seed gives the same weights on
    every device; load others with ``trainer.model.load_state_dict``."""

    def __init__(self, data_dir: str, cfg: Optional[TrainingConfig] = None,
                 *, device="cuda", model_dtype=torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        self.cfg = cfg or TrainingConfig()
        self.device = torch.device(device)
        self.model_dtype = model_dtype
        self.dataset = ComMUDataset(data_dir)
        model = TransformerXL(VOCAB_SIZE, self.cfg.model, dtype=model_dtype)
        model.init_parameters(
            generator or torch.Generator().manual_seed(self.cfg.train.seed))
        self.model = model.to(self.device).eval()
        self.eval_step = make_eval_step(self.model, same_length=True)
        # one device: the reference's eval batch as it is
        self.eval_batch = self.cfg.evaluate.batch_size

    @torch.inference_mode()
    def evaluate(self, split: str = "valid") -> tuple[int, float]:
        """(token_count, total_nll) over the split.  Memory is reset at each
        sequence-batch boundary (a fresh zero ring), as the reference's
        ``mems = None`` on ``reset_all_mem``."""
        ecfg, mcfg = self.cfg.evaluate, self.cfg.model
        total_tokens = 0
        nll_parts = []
        memory = None
        reset = torch.zeros(self.eval_batch, dtype=torch.bool,
                            device=self.device)
        for batch in self.dataset.eval_iterator(
                self.eval_batch, ecfg.tgt_length, split=split):
            if batch.reset[0] or memory is None:
                memory = init_memory(mcfg.num_layers, self.eval_batch,
                                     ecfg.mem_length, mcfg.units,
                                     dtype=self.model_dtype,
                                     block_len=ecfg.tgt_length,
                                     device=self.device)
            nll_sum, _, memory = self.eval_step(
                memory, self._feed(batch.inputs), self._feed(batch.targets),
                reset)
            nll_parts.append(nll_sum)
            total_tokens += batch.token_count
        total_nll = float(torch.stack(nll_parts).double().sum()) \
            if nll_parts else 0.0
        return total_tokens, total_nll

    def _feed(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device, non_blocking=True)
