"""Dropout masks from a counter hash: the shared helpers of every kernel
that drops.

PyTorch counterpart of the mask contract of ``commu_tpu/ops/
fused_attention.py``: ``_prng_seed`` / ``_prng_random_bits`` in their
off-TPU form (:140-162, a splitmix32-style hash of seed, draw count and
element index), ``effective_dropout_p`` and ``keep_scale_for`` (:272-287) and
the 16-bit branch of ``random_keep`` (:337-358).  ``keep_mask`` gives, bit
for bit, the mask the JAX package's kernels draw in interpret mode for the
same seed; ``csrc/prng.cuh`` computes the same bit for one element inside a
kernel, so no mask tensor exists on the card.  The TPU's hardware generator
is not reproduced, and neither is the 8-bit draw variant
(``COMMU_DROPOUT_BITS=8``, :306-336).

The word of drawn-array element ``idx`` (row-major in the drawn shape) is

    x = idx + seed * 0x9E3779B9 + calls * 0x85EBCA6B        (uint32)
    x = (x ^ x >> 16) * 0x7FEB352D
    x = (x ^ x >> 15) * 0x846CA68B
    x ^= x >> 16

with ``calls = 1`` (every site seeds, then draws once).  One word serves two
mask elements where the plane splits cleanly (``draw_geometry``); an element
is kept where its 16-bit half is ``>= t16`` (unsigned),
``t16 = min(0xFFFF, round(p * 65536))``, and kept values are scaled by
``1 / (1 - t16 / 65536)``.
"""
from __future__ import annotations

from typing import Tuple

import torch

_M32 = 0xFFFFFFFF
_SEED_MUL = 0x9E3779B9
_CALL_MUL = 0x85EBCA6B  # times the draw count, which is always 1


def dropout_threshold(dropout_p: float) -> int:
    """t16: a 16-bit half below it drops its element (0: nothing drops)."""
    if not dropout_p or dropout_p <= 0.0:
        return 0
    return min(0xFFFF, round(dropout_p * 65536.0))


def effective_dropout_p(dropout_p: float) -> float:
    """The exact Bernoulli rate the 16-bit compare realises."""
    return dropout_threshold(dropout_p) / 65536.0


def keep_scale_for(dropout_p: float, train: bool = True) -> float:
    """1 / keep-probability at the realised (quantised) rate."""
    if not train or not dropout_p or dropout_p <= 0.0:
        return 1.0
    return 1.0 / (1.0 - effective_dropout_p(dropout_p))


def draw_geometry(rows: int, cols: int) -> Tuple[int, int]:
    """(mode, half) of a [rows, cols] mask plane, as ``random_keep`` splits
    it: mode 0 draws [rows, cols/2] and columns >= half read the high 16
    bits of word (i, j - half); mode 1 draws [rows/2, cols] and rows >= half
    read the high bits of word (i - half, j); mode 2 draws the whole plane
    and reads the high bits.  ``csrc/prng.cuh`` repeats this rule."""
    if cols % 2 == 0 and (cols // 2) % 128 == 0:
        return 0, cols // 2
    if rows % 2 == 0:
        return 1, rows // 2
    return 2, 0


def keep_mask(seed, shape: Tuple[int, int], dropout_p: float,
              device=None) -> torch.Tensor:
    """Bernoulli(1 - p) keep mask of a [rows, cols] plane, bool.  ``seed``:
    a Python int or an integer tensor of any shape S (one plane per seed;
    the result is S + [rows, cols]); only its low 32 bits count, as an int32
    sum with wraparound read as uint32."""
    rows, cols = shape
    t16 = dropout_threshold(dropout_p)
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device)
    dev = seed.device
    i = torch.arange(rows, dtype=torch.int64, device=dev)[:, None]
    j = torch.arange(cols, dtype=torch.int64, device=dev)[None, :]
    mode, half = draw_geometry(rows, cols)
    if mode == 0:
        high = (j >= half).expand(rows, cols)
        idx = i * half + j % half
    elif mode == 1:
        high = (i >= half).expand(rows, cols)
        idx = (i % half) * cols + j
    else:
        high = None
        idx = i * cols + j
    # int64 arithmetic wraps, and the low 32 bits of a wrapped product are
    # those of the uint32 product
    base = ((seed & _M32) * _SEED_MUL + _CALL_MUL) & _M32
    x = (idx + base[..., None, None]) & _M32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _M32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _M32
    x = x ^ (x >> 16)
    hi = x >> 16
    bits = hi if high is None else torch.where(high, hi, x & 0xFFFF)
    return bits >= t16


def row_seeds(seed: int, count: int, stride: int, offset: int = 0,
              device=None) -> torch.Tensor:
    """[count] int64 seeds ``seed + b * stride + offset`` of the planes of
    ``count`` batch rows (``keep_mask`` wraps them to 32 bits)."""
    return int(seed) + offset + stride * torch.arange(
        count, dtype=torch.int64, device=device)


def kernel_args(seed: int, dropout_p: float) -> Tuple[int, int, float]:
    """(seed, t16, keep_scale) as a kernel launch takes them: the seed
    wrapped to a signed 32-bit int, the threshold (0: no dropout) and the
    scale."""
    wrapped = ((int(seed) + 0x80000000) & _M32) - 0x80000000
    return (wrapped, dropout_threshold(dropout_p),
            float(keep_scale_for(dropout_p)))
