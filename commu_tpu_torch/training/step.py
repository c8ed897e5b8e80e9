"""The train step and the windowed eval step.

PyTorch counterpart of ``commu_tpu/training/step.py`` on the kernel path
with one physical chunk (``resolve_physical_chunks`` returns 1 there):

- ``make_train_step``: the step's dropout draw, the forward over the XL ring
  with autograd (``TransformerXL.forward_train``, ``deterministic=False``
  in the reference), the fused tied-embedding NLL, the reference's
  chunk-mean loss, ``backward()`` through the hand-written
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
from typing import Callable, Optional, Tuple

import torch

from ..config import TrainingConfig
from ..vocab.event_tokens import PAD_ID

from ..models.transformer_xl import (DropoutDraw, TransformerXL,
                                     draw_dropout, memory_capacity)
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


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one step's dropout draw, a function of the run's
    seed and the step alone (the counterpart of the reference's
    ``fold_in(rng, state.step)`` and chunk 0, ``step.py:271``): a resumed
    run continues the stream from its step.  The reference's own threefry
    numbers are not reproduced."""
    return torch.Generator().manual_seed(
        (int(seed) * 0x9E3779B97F4A7C15 + int(step) * 0xD1B54A32D192ED03
         + 0x5851F42D4C957F2D) & (2 ** 63 - 1))


def make_train_step(model: TransformerXL, optimizer, scheduler,
                    cfg: TrainingConfig,
                    draw: Optional[Callable[..., DropoutDraw]] = None
                    ) -> Callable:
    """train_step(memory, inputs, targets, reset) -> (new_memory, metrics)
    for one window on one device: inputs, targets [B, T] int and reset [B]
    bool on the model's device; ``memory`` (``init_memory`` with block_len
    T, in the compute dtype) is advanced in place after the update.

    With dropout or attention dropout above 0 every step takes a
    ``DropoutDraw`` from ``draw(step, k_len, device)``, ``step`` being the
    count of updates made so far (the scheduler's, so a restored one carries
    on), ``k_len`` the memory capacity plus the window and ``device`` the
    inputs'.  The default draws its seeds on the host from
    ``step_generator(cfg.train.seed, step)``: no device sync."""
    mcfg = cfg.model
    dropping = mcfg.dropout > 0.0 or mcfg.attention_dropout > 0.0
    if draw is None:
        def draw(step, k_len, device):
            return draw_dropout(step_generator(cfg.train.seed, step), mcfg,
                                k_len, device)
    # the reference's semantic chunk count, batch_chunk x num_devices, over
    # one physical chunk
    sem_chunks = cfg.train.batch_chunk
    params = list(model.parameters())

    def train_step(memory, inputs, targets, reset):
        optimizer.zero_grad(set_to_none=True)
        dropout = draw(scheduler.last_epoch,
                       memory_capacity(memory) + inputs.shape[1],
                       inputs.device) if dropping else None
        hidden, rows = model.forward_train(
            inputs, reset, memory, same_length=mcfg.same_length,
            dropout=dropout)
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
