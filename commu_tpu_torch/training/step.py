"""The train step and the windowed eval step.

PyTorch counterpart of ``commu_tpu/training/step.py``, on both model paths:

- ``make_train_step``: the step's dropout draw, the forward over the XL
  memory with autograd (``TransformerXL.forward_train``,
  ``deterministic=False`` in the reference), the NLL, the reference's
  chunk-mean loss, ``backward()``, the torch-semantics clip, Adam with the
  Noam schedule, and only then the memory's advance: the attention
  backward reads the memory, so it must not change before.  On the kernel
  path that is one physical chunk (``resolve_physical_chunks``) over the
  ring, the fused tied-embedding NLL and the hand-written backward kernels;
  on the unfused path ``batch_chunk`` physical chunks, each with its own
  rows of a dense memory [C, L+1, B/C, M, D] (``init_train_memory``), whose
  gradients add up over the chunks, ``token_nll`` over the logits, and the
  shift of the dense memory.
- ``make_eval_step``: the forward over the memory and the NLL sum.

Under a process group (``..parallel``: one rank a device, each with its
own rows of the global batch) the train step averages the gradients over
the ranks and sums ``nll_sum`` and ``token_count`` over them in one
all-reduce after the last backward and before the clip, as the JAX step's
manual data parallelism does (``commu_tpu/training/step.py:399-406``).

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

from ..models.transformer_xl import (Memory, TransformerXL, draw_dropout,
                                     dropout_generator, memory_capacity,
                                     resolve_attn_impl, shift_memory,
                                     token_nll)
from ..ops import _build
from ..ops.fused_nll import fused_token_nll
from ..parallel import mesh, multihost
from . import schedule


def resolve_physical_chunks(cfg: TrainingConfig) -> int:
    """How many forward/backward passes realise the ``batch_chunk`` loss
    (whose mean-of-chunk-means semantics never change): 1 on the kernel
    path, which never materialises the attention probabilities, and
    ``batch_chunk`` on the unfused path, as the reference's GPU training
    chunks to fit its memory."""
    if resolve_attn_impl(cfg.model) == "pallas":
        return 1
    return cfg.train.batch_chunk


def init_train_memory(num_layers: int, batch: int, capacity: int,
                      d_model: int, n_chunks: int, dtype=torch.float32,
                      device=None) -> Memory:
    """The unfused path's empty training memory: a dense ``Memory`` whose
    hidden is [C, L+1, B/C, M, D], chunk c's rows ahead of its streams, so
    ``hidden[c]`` is chunk c's dense memory as the model takes it."""
    if batch % n_chunks:
        raise ValueError(f"batch {batch} does not split into {n_chunks} "
                         "chunks")
    return Memory(torch.zeros((n_chunks, num_layers + 1, batch // n_chunks,
                               capacity, d_model), dtype=dtype,
                              device=device), dense=True)


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
    with _build.span("clip"):
        grads = [p.grad for p in params if p.grad is not None]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
        for g in grads:
            g.mul_(scale.to(g.dtype))
    return norm


def make_optimizer(model: TransformerXL, cfg: TrainingConfig,
                   num_devices: int = 1):
    """(Adam, LambdaLR): Adam(betas=(0.9, 0.999), eps=1e-8) at
    ``lr / num_devices`` (the reference's ``local_lr``), torch's weight
    decay (added to the gradient before the moments, as the reference's
    chain does), and the Noam multiplier."""
    tcfg = cfg.train
    opt = torch.optim.Adam(model.parameters(),
                           lr=schedule.base_lr(tcfg, num_devices),
                           betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=tcfg.weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, functools.partial(schedule.multiplier, tcfg))
    return opt, sched


def step_generator(seed: int, step: int, rank: int = 0) -> torch.Generator:
    """The CPU generator of one step's dropout draw, a function of the run's
    seed, the step and the rank alone (the counterpart of the reference's
    ``fold_in(rng, state.step)`` and chunk 0, ``step.py:271``, and of its
    ``fold_in(axis_index)``, ``:272-276``: the kernels seed their masks by
    local row, so ranks must draw apart): a resumed run continues the stream
    from its step.  Rank 0, and so a run of one process, draws what it drew
    before ranks existed.  The reference's own threefry numbers are not
    reproduced."""
    return torch.Generator().manual_seed(
        (int(seed) * 0x9E3779B97F4A7C15 + int(step) * 0xD1B54A32D192ED03
         + int(rank) * 0x94D049BB133111EB + 0x5851F42D4C957F2D)
        & (2 ** 63 - 1))


def make_train_step(model: TransformerXL, optimizer, scheduler,
                    cfg: TrainingConfig,
                    draw: Optional[Callable] = None) -> Callable:
    """train_step(memory, inputs, targets, reset) -> (new_memory, metrics)
    for one window on one device: inputs, targets [B, T] int and reset [B]
    bool on the model's device.  ``memory``: on the kernel path a ring
    (``init_memory`` with block_len T, in the compute dtype), advanced in
    place after the update; on the unfused path ``init_train_memory``'s
    dense memory of ``resolve_physical_chunks(cfg)`` chunks, replaced by
    its shifted successor.

    With dropout or attention dropout above 0 every step takes a draw from
    ``draw(step, k_len, device)``, ``step`` being the count of updates made
    so far (the scheduler's, so a restored one carries on), ``k_len`` the
    memory capacity plus the window and ``device`` the inputs': a
    ``DropoutDraw`` on the kernel path, a ``torch.Generator`` on the
    unfused one (its chunks draw from it in turn).  The default draws its
    seeds on the host from ``step_generator(cfg.train.seed, step, rank)``:
    no device sync.

    Under a process group each rank feeds its own rows; the gradients are
    averaged and the metric sums summed over the ranks before the clip
    (``parallel.mesh.reduce_gradients``)."""
    mcfg = cfg.model
    dropping = mcfg.dropout > 0.0 or mcfg.attention_dropout > 0.0
    fused = resolve_attn_impl(mcfg) == "pallas"
    rank = multihost.process_index()
    if draw is None:
        def draw(step, k_len, device):
            generator = step_generator(cfg.train.seed, step, rank)
            if fused:
                return draw_dropout(generator, mcfg, k_len, device)
            return dropout_generator(generator, device)
    # the reference's semantic chunk count is batch_chunk x num_devices:
    # each rank's loss is the mean of batch_chunk chunk means over its own
    # rows, and the gradient mean over the ranks makes it the mean over all
    # of them, as the JAX step's manual data parallelism does; per rank,
    # n_chunks physical chunks of sem_chunks / n_chunks semantic ones each
    sem_chunks = cfg.train.batch_chunk
    n_chunks = resolve_physical_chunks(cfg)
    params = list(model.parameters())

    def chunk_pass(memory, inputs, targets, reset, dropout):
        """Forward and backward of one physical chunk: (rows, nll_sum,
        token_count); the gradients add into ``.grad``."""
        hidden, rows = model.forward_train(
            inputs, reset, memory, same_length=mcfg.same_length,
            dropout=dropout)
        if fused:
            nll = fused_token_nll(hidden.transpose(1, 2), model.embedding,
                                  model.out_bias, targets)
        else:
            nll = token_nll(model.logits(hidden), targets)
        loss, nll_sum, token_count = masked_chunk_loss(
            nll, targets, sem_chunks // n_chunks)
        (loss / n_chunks).backward()
        return rows, nll_sum.detach(), token_count

    def train_step(memory, inputs, targets, reset):
        optimizer.zero_grad(set_to_none=True)
        dropout = draw(scheduler.last_epoch,
                       memory_capacity(memory) + inputs.shape[1],
                       inputs.device) if dropping else None
        if fused:
            rows, nll_sum, token_count = chunk_pass(memory, inputs, targets,
                                                    reset, dropout)
        else:
            if memory.hidden.shape[0] != n_chunks:
                raise ValueError(
                    f"the memory has {memory.hidden.shape[0]} physical "
                    f"chunks, the step {n_chunks} (init_train_memory and "
                    "make_train_step must agree)")
            parts = [chunk_pass(
                Memory(memory.hidden[c], memory.count, dense=True), *args,
                dropout) for c, args in enumerate(zip(
                    inputs.chunk(n_chunks), targets.chunk(n_chunks),
                    reset.chunk(n_chunks)))]
            nll_sum = torch.stack([p[1] for p in parts]).sum()
            token_count = torch.stack([p[2] for p in parts]).sum()
        if multihost.is_initialized():
            nll_sum, token_count = mesh.reduce_gradients(params, nll_sum,
                                                         token_count)
        grad_norm = _clip_by_global_norm(params, cfg.train.clip)
        optimizer.step()
        scheduler.step()
        if fused:
            new_memory = model.advance_memory(memory, rows)
        else:
            # [C, L+1, B/C, T, D] rows into the [C, L+1, B/C, M, D] memory
            stacked = torch.stack([torch.stack(p[0]) for p in parts])
            new_memory = Memory(
                shift_memory(memory.hidden, stacked),
                min(memory.count + inputs.shape[1], memory_capacity(memory)),
                dense=True)
        return new_memory, {"nll_sum": nll_sum,
                            "token_count": token_count,
                            "grad_norm": grad_norm}

    return train_step


def make_eval_step(model: TransformerXL, *, same_length: bool = True
                   ) -> Callable:
    """eval_step(memory, inputs, targets, reset) -> (nll_sum, token_count,
    new_memory) for one window: inputs, targets [B, T] int and reset [B]
    bool on the model's device; the sums are 0-d f32 tensors left on the
    device (no sync).  The kernel path advances its ring in place and
    fuses the NLL with the output projection; the unfused path shifts a
    dense memory and takes ``token_nll`` of the logits."""
    fused = model.attn_impl == "pallas"

    @torch.inference_mode()
    def eval_step(memory, inputs, targets, reset):
        hidden, new_memory = model(inputs, reset, memory=memory,
                                   same_length=same_length)
        if fused:
            nll = fused_token_nll(hidden.transpose(1, 2), model.embedding,
                                  model.out_bias, targets)
        else:
            nll = token_nll(model.logits(hidden), targets)
        mask = (targets != PAD_ID).float()
        return (nll * mask).sum(), mask.sum(), new_memory

    return eval_step
