"""XL relative-position attention primitives for the unfused attention path.

PyTorch counterpart of ``commu_tpu/ops/rel_attention.py``: plain torch, no
kernel (the reference computes them outside any Pallas kernel too).  The
memory buffer has a fixed capacity M with its valid region right-aligned, so
every shape is static and the number of valid memory slots (``mem_count``)
enters through masks alone.  With key index j over [0, M+T) and query index
i over [0, T):

    causal block         j >= M + i + 1
    invalid-buffer block j < M - mem_count
    same_length block    j <= i - shift + (M - mem_count),
                         shift = T - max(mem_count + T - M, 0)
    reset-row block      all memory keys (j < M) of rows starting a sequence
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Align the query·position term BD from distance-indexed to key-indexed:
    ``x[b, h, i, d]`` scores query i against distance ``klen - 1 - d``; the
    result's key j of query i holds distance ``(M + i) - j``.  The pad and
    reshape trick of the reference's ``_rel_shift``."""
    b, h, t, k = x.shape
    x = F.pad(x, (1, 0))
    x = x.reshape(b, h, k + 1, t)
    return x[:, :, 1:, :].reshape(b, h, t, k)


def relative_position_embedding(klen: int, d_model: int,
                                dtype=torch.float32, clamp_len: int = -1,
                                device=None) -> torch.Tensor:
    """Sinusoidal embedding [klen, d_model] of the descending distances
    ``[klen-1, ..., 0]``, clamped at ``clamp_len`` when it is positive;
    computed in f32, then cast to ``dtype``."""
    pos_seq = torch.arange(klen - 1, -1, -1, dtype=torch.float32,
                           device=device)
    if clamp_len > 0:
        pos_seq = torch.clamp(pos_seq, max=float(clamp_len))
    inv_freq = 1.0 / (10000.0 ** (torch.arange(
        0, d_model, 2, dtype=torch.float32, device=device) / d_model))
    sinusoid = torch.outer(pos_seq, inv_freq)
    return torch.cat([torch.sin(sinusoid), torch.cos(sinusoid)],
                     dim=-1).to(dtype)


def build_attention_mask(tgt_len: int, mem_capacity: int, mem_count: int,
                         reset: Optional[torch.Tensor], same_length: bool,
                         batch: int, device=None) -> torch.Tensor:
    """Boolean mask [B, 1, T, M+T], True where attention is blocked, over
    the right-aligned buffer (see the module docstring).  ``mem_count``: the
    valid memory slots (a host integer); ``reset``: [B] bool or None."""
    klen = mem_capacity + tgt_len
    i = torch.arange(tgt_len, device=device)[:, None]
    j = torch.arange(klen, device=device)[None, :]
    mask = (j >= mem_capacity + i + 1) | (j < mem_capacity - mem_count)
    if same_length:
        shift = tgt_len - max(mem_count + tgt_len - mem_capacity, 0)
        mask = mask | (j <= i - shift + (mem_capacity - mem_count))
    mask = mask[None, None].expand(batch, 1, tgt_len, klen)
    if reset is not None:
        mem_keys = (j < mem_capacity)[None, None]
        mask = mask | (reset.to(torch.bool)[:, None, None, None] & mem_keys)
    return mask
