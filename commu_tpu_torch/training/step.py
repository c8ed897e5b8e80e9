"""The windowed eval step.

PyTorch counterpart of ``commu_tpu/training/step.py::make_eval_step`` on the
kernel path: the forward over the XL memory, then the fused tied-embedding
NLL, summed over non-pad targets.
"""
from __future__ import annotations

from typing import Callable

import torch

from commu_tpu.vocab.event_tokens import PAD_ID

from ..models.transformer_xl import TransformerXL
from ..ops.fused_nll import fused_token_nll


def make_eval_step(model: TransformerXL, *, same_length: bool = True
                   ) -> Callable:
    """eval_step(memory, inputs, targets, reset) -> (nll_sum, token_count,
    new_memory) for one window: inputs, targets [B, T] int and reset [B]
    bool on the model's device; the sums are 0-d f32 tensors left on the
    device (no sync); the memory's ring is advanced in place."""

    @torch.inference_mode()
    def eval_step(memory, inputs, targets, reset):
        hidden, new_memory = model(inputs, reset, memory=memory,
                                   same_length=same_length)
        nll = fused_token_nll(hidden.transpose(1, 2), model.embedding,
                              model.out_bias, targets)
        mask = (targets != PAD_ID).float()
        return (nll * mask).sum(), mask.sum(), new_memory

    return eval_step
