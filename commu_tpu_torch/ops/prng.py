"""Dropout masks from a counter hash: the shared helpers of every kernel
that drops.

PyTorch counterpart of the mask contract of ``commu_tpu/ops/
fused_attention.py``: ``_prng_seed`` / ``_prng_random_bits`` in their
off-TPU form (:140-162, a splitmix32-style hash of seed, draw count and
element index), ``_dropout_bits``, ``effective_dropout_p`` and
``keep_scale_for`` (:258-287) and ``random_keep`` (:290-358) at both draw
widths.  ``keep_mask`` gives, bit for bit, the mask the JAX package's kernels
draw in interpret mode for the same seed and width; ``csrc/prng.cuh`` computes
the same bit for one element inside a kernel, so no mask tensor exists on the
card.  The TPU's hardware generator is not reproduced.

The word of drawn-array element ``idx`` (row-major in the drawn shape) is

    x = idx + seed * 0x9E3779B9 + calls * 0x85EBCA6B        (uint32)
    x = (x ^ x >> 16) * 0x7FEB352D
    x = (x ^ x >> 15) * 0x846CA68B
    x ^= x >> 16

with ``calls = 1`` (every site seeds, then draws once).

The draw width (``COMMU_DROPOUT_BITS``, ``dropout_bits``) is the number of
random bits a decision takes: 16 by default, 8 where the training entry point
selects the reference's fast numerics.  One word serves 32 / width mask
elements where the plane splits cleanly (``draw_geometry``).  At 16 bits an
element is kept where its half is ``>= t16`` (unsigned), ``t16 =
min(0xFFFF, round(p * 65536))``; at 8 bits where its byte is ``>= t8``,
``t8 = min(255, round(p * 256))`` (a plane that does not quarter compares a
16-bit value against ``t8 << 8``: the same rate).  Kept values are scaled by
``1 / (1 - t / 2^bits)``.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

_M32 = 0xFFFFFFFF
_SEED_MUL = 0x9E3779B9
_CALL_MUL = 0x85EBCA6B  # times the draw count, which is always 1


def _width(bits: Optional[int]) -> int:
    """``bits``, or ``COMMU_DROPOUT_BITS`` (16 when unset) for None: 8 or 16."""
    if bits is None:
        bits = int(os.environ.get("COMMU_DROPOUT_BITS", "16"))
    if bits not in (8, 16):
        raise ValueError(f"draw width {bits} (COMMU_DROPOUT_BITS): the "
                         "masks are drawn at 8 or 16 bits")
    return bits


def dropout_bits() -> int:
    """COMMU_DROPOUT_BITS (read at each call, as the reference does): random
    bits per dropout decision, 16 (default) or 8."""
    return _width(None)


def dropout_threshold(dropout_p: float, bits: Optional[int] = None) -> int:
    """The threshold at draw width ``bits``: a value below it drops its
    element (0: nothing drops)."""
    bits = _width(bits)
    if not dropout_p or dropout_p <= 0.0:
        return 0
    return min((1 << bits) - 1, round(dropout_p * float(1 << bits)))


def effective_dropout_p(dropout_p: float, bits: Optional[int] = None) -> float:
    """The exact Bernoulli rate the compare realises at this width."""
    bits = _width(bits)
    return dropout_threshold(dropout_p, bits) / float(1 << bits)


def keep_scale_for(dropout_p: float, train: bool = True,
                   bits: Optional[int] = None) -> float:
    """1 / keep-probability at the realised (quantised) rate."""
    if not train or not dropout_p or dropout_p <= 0.0:
        return 1.0
    return 1.0 / (1.0 - effective_dropout_p(dropout_p, bits))


def draw_geometry(rows: int, cols: int,
                  bits: Optional[int] = None) -> Tuple[int, int, int]:
    """(mode, part, width) of a [rows, cols] mask plane, as ``random_keep``
    splits it.  Mode 0 cuts the columns into 32 / width pieces of ``part``:
    piece n of column j reads bits [n * width, (n + 1) * width) of word
    (i, j - n * part) of a drawn [rows, part] array; mode 1 cuts the rows
    the same way (word (i - n * part, j) of [part, cols]); mode 2 draws the
    whole plane and reads the high 16 bits.  At 8 bits the order is columns
    quartered, rows quartered, then the 16-bit rule (columns halved, rows
    halved, whole), whose values compare against ``t8 << 8``.
    ``csrc/prng.cuh`` repeats this rule."""
    if _width(bits) == 8:
        if cols % 4 == 0 and (cols // 4) % 128 == 0:
            return 0, cols // 4, 8
        if rows % 4 == 0:
            return 1, rows // 4, 8
    if cols % 2 == 0 and (cols // 2) % 128 == 0:
        return 0, cols // 2, 16
    if rows % 2 == 0:
        return 1, rows // 2, 16
    return 2, 0, 16


def keep_mask(seed, shape: Tuple[int, int], dropout_p: float,
              device=None, bits: Optional[int] = None) -> torch.Tensor:
    """Bernoulli(1 - p) keep mask of a [rows, cols] plane, bool, at draw
    width ``bits`` (``dropout_bits()`` when None).  ``seed``: a Python int
    or an integer tensor of any shape S (one plane per seed; the result is
    S + [rows, cols]); only its low 32 bits count, as an int32 sum with
    wraparound read as uint32."""
    rows, cols = shape
    bits = _width(bits)
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device)
    dev = seed.device
    i = torch.arange(rows, dtype=torch.int64, device=dev)[:, None]
    j = torch.arange(cols, dtype=torch.int64, device=dev)[None, :]
    mode, part, width = draw_geometry(rows, cols, bits)
    if mode == 0:
        piece = (j // part).expand(rows, cols)
        idx = i * part + j % part
    elif mode == 1:
        piece = (i // part).expand(rows, cols)
        idx = (i % part) * cols + j
    else:
        piece = None
        idx = i * cols + j
    # int64 arithmetic wraps, and the low 32 bits of a wrapped product are
    # those of the uint32 product
    base = ((seed & _M32) * _SEED_MUL + _CALL_MUL) & _M32
    x = (idx + base[..., None, None]) & _M32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _M32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _M32
    x = x ^ (x >> 16)
    value = x >> 16 if piece is None else \
        (x >> (piece * width)) & ((1 << width) - 1)
    # a 16-bit value against an 8-bit threshold: t8 << 8, the same rate
    return value >= (dropout_threshold(dropout_p, bits) << (width - bits))


def row_seeds(seed: int, count: int, stride: int, offset: int = 0,
              device=None) -> torch.Tensor:
    """[count] int64 seeds ``seed + b * stride + offset`` of the planes of
    ``count`` batch rows (``keep_mask`` wraps them to 32 bits)."""
    return int(seed) + offset + stride * torch.arange(
        count, dtype=torch.int64, device=device)


def kernel_args(seed: int, dropout_p: float,
                bits: Optional[int] = None) -> Tuple[int, int, float, int]:
    """(seed, threshold, keep_scale, bits) as a kernel launch takes them:
    the seed wrapped to a signed 32-bit int, the threshold at the draw width
    (0: no dropout), the scale and the width."""
    bits = _width(bits)
    wrapped = ((int(seed) + 0x80000000) & _M32) - 0x80000000
    return (wrapped, dropout_threshold(dropout_p, bits),
            float(keep_scale_for(dropout_p, bits=bits)), bits)
