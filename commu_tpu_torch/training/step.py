"""The train step and the windowed eval step.

PyTorch counterpart of ``commu_tpu/training/step.py`` on the kernel path
with one physical chunk (``resolve_physical_chunks`` returns 1 there):

- ``make_train_step``: the forward over the XL ring with autograd
  (``TransformerXL.forward_train``), the fused tied-embedding NLL, the
  reference's chunk-mean loss, ``backward()`` through the hand-written
  backward kernels, the torch-semantics clip, Adam with the Noam schedule,
  and only then the ring write and the advance of ``count``/``head``: the
  attention backward reads the ring, so it must not change before.
- ``make_eval_step``: the forward over the memory and the NLL sum.

Metric contract (the JAX step's): ``nll_sum`` (NLL summed over non-pad
targets), ``token_count`` (non-pad targets) and ``grad_norm`` (the global
gradient norm before clipping), as 0-d f32 tensors left on the device.
"""
from __future__ import annotations

import functools
from typing import Callable, Tuple

import torch

from commu_tpu.config import TrainingConfig
from commu_tpu.vocab.event_tokens import PAD_ID

from ..models.transformer_xl import TransformerXL
from ..ops.fused_nll import fused_token_nll
from . import schedule


def masked_chunk_loss(nll: torch.Tensor, targets: torch.Tensor,
                      num_chunks: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, nll_sum, token_count) with the reference's chunk semantics:
    the batch splits into ``num_chunks`` chunks of rows, and the loss is the
    mean over chunks of each chunk's masked mean NLL."""
    mask = (targets != PAD_ID).float()
    batch = targets.shape[0]
    if batch % num_chunks:
        raise ValueError(f"batch {batch} does not split into {num_chunks} "
                         "chunks")
    nll_c = (nll * mask).reshape(num_chunks, -1).sum(dim=1)
    tok_c = mask.reshape(num_chunks, -1).sum(dim=1)
    loss = (nll_c / torch.clamp(tok_c, min=1.0)).mean()
    return loss, (nll * mask).sum(), mask.sum()


def _clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """``torch.nn.utils.clip_grad_norm_`` semantics: scale every gradient by
    ``min(1, max_norm / (norm + 1e-6))``; returns the pre-clip norm (0-d
    f32).  Each parameter counts once, the tied embedding included."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


def make_optimizer(model: TransformerXL, cfg: TrainingConfig):
    """(Adam, LambdaLR): Adam(betas=(0.9, 0.999), eps=1e-8) at
    ``lr / num_devices`` with one device, torch's weight decay (added to the
    gradient before the moments, as the reference's chain does), and the
    Noam multiplier."""
    tcfg = cfg.train
    opt = torch.optim.Adam(model.parameters(), lr=schedule.base_lr(tcfg),
                           betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=tcfg.weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, functools.partial(schedule.multiplier, tcfg))
    return opt, sched


def make_train_step(model: TransformerXL, optimizer, scheduler,
                    cfg: TrainingConfig) -> Callable:
    """train_step(memory, inputs, targets, reset) -> (new_memory, metrics)
    for one window on one device: inputs, targets [B, T] int and reset [B]
    bool on the model's device; ``memory`` (``init_memory`` with block_len
    T, in the compute dtype) is advanced in place after the update."""
    if cfg.model.dropout > 0.0 or cfg.model.attention_dropout > 0.0:
        raise NotImplementedError("training dropout is not ported")
    # the reference's semantic chunk count, batch_chunk x num_devices, over
    # one physical chunk
    sem_chunks = cfg.train.batch_chunk
    params = list(model.parameters())

    def train_step(memory, inputs, targets, reset):
        optimizer.zero_grad(set_to_none=True)
        hidden, rows = model.forward_train(
            inputs, reset, memory, same_length=cfg.model.same_length)
        nll = fused_token_nll(hidden.transpose(1, 2), model.embedding,
                              model.out_bias, targets)
        loss, nll_sum, token_count = masked_chunk_loss(nll, targets,
                                                       sem_chunks)
        loss.backward()
        grad_norm = _clip_by_global_norm(params, cfg.train.clip)
        optimizer.step()
        scheduler.step()
        new_memory = model.advance_memory(memory, rows)
        return new_memory, {"nll_sum": nll_sum.detach(),
                            "token_count": token_count,
                            "grad_norm": grad_norm}

    return train_step


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
