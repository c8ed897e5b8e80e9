"""Activation dropout over [B, D, T] with the mask drawn from a hash.

PyTorch counterpart of ``commu_tpu/ops/dropout.py::dropout_bdt``: one
hand-written CUDA kernel (``csrc/dropout_bdt.cu``) with a plain PyTorch twin
of the same signature.  Batch row b draws the plane [D, T] seeded with
``seed + b * 16384 + salt * 512`` (``ops.prng``); kept values are multiplied
by the keep-scale rounded to x's dtype, in x's dtype.  The backward applies
the same mask to the cotangent, regenerated from the seed: nothing is saved.
The model uses it at the embedding and output sites.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build, prng

# site salts of the embedding and output streams (dropout.py:32)
SALT_EMB, SALT_OUT = 5, 6
_DTYPES = (torch.float32, torch.bfloat16)


def dropout_bdt_plain(x: torch.Tensor, seed: int, dropout_p: float,
                      salt: int, bits: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: x [B, D, T] -> y, same dtype.
    ``bits``: the draw width, 8 or 16 (``prng.dropout_bits()`` when None)."""
    b, d, t = x.shape
    keep = prng.keep_mask(
        prng.row_seeds(seed, b, 16384, salt * 512, device=x.device), (d, t),
        dropout_p, bits=bits)
    scale = torch.tensor(prng.keep_scale_for(dropout_p, bits=bits),
                         dtype=x.dtype, device=x.device)
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


def dropout_bdt_apply(x: torch.Tensor, seed: int, dropout_p: float,
                      salt: int, bits: Optional[int] = None) -> torch.Tensor:
    """One pass of the mask over x [B, D, T] (forward and backward are the
    same pass).  CPU tensors run ``dropout_bdt_plain``; CUDA tensors launch
    ``csrc/dropout_bdt.cu``."""
    if not _build.use_kernel(x):
        return dropout_bdt_plain(x, seed, dropout_p, salt, bits)
    if x.dim() != 3:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected [B, D, T]")
    _build.check("x", x, x.shape, _DTYPES)
    b, d, t = x.shape
    y = torch.empty_like(x)
    drop = prng.kernel_args(seed, dropout_p, bits)
    _build.launch(
        _build.form("dropout_bdt", False, drop[1], drop[3]), x.device,
        0 if x.dtype == torch.float32 else 1, x.data_ptr(), y.data_ptr(),
        int(salt), *drop, b, d, t)
    return y


class _DropoutBDT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, dropout_p, salt, bits):
        ctx.args = (seed, dropout_p, salt, bits)
        return dropout_bdt_apply(x.contiguous(), *ctx.args)

    @staticmethod
    def backward(ctx, g):
        return (dropout_bdt_apply(g.contiguous(), *ctx.args), None, None,
                None, None)


def dropout_bdt(x: torch.Tensor, seed: int, dropout_p: float,
                salt: int, bits: Optional[int] = None) -> torch.Tensor:
    """Inverted dropout on x [B, D, T]: keep with the realised probability
    ``1 - effective_dropout_p(p)`` and scale by its inverse.  ``seed``: a
    Python int (its low 32 bits count); ``bits``: the draw width, read from
    ``COMMU_DROPOUT_BITS`` here when None, and the backward redraws at the
    forward's.  Differentiable in x."""
    if dropout_p <= 0.0:
        return x
    return _DropoutBDT.apply(x, int(seed), float(dropout_p), int(salt),
                             prng.dropout_bits() if bits is None else bits)
