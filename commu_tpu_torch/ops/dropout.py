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

import torch

from . import _build, prng

# site salts of the embedding and output streams (dropout.py:32)
SALT_EMB, SALT_OUT = 5, 6
_DTYPES = (torch.float32, torch.bfloat16)


def dropout_bdt_plain(x: torch.Tensor, seed: int, dropout_p: float,
                      salt: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: x [B, D, T] -> y, same dtype."""
    b, d, t = x.shape
    keep = prng.keep_mask(
        prng.row_seeds(seed, b, 16384, salt * 512, device=x.device), (d, t),
        dropout_p)
    scale = torch.tensor(prng.keep_scale_for(dropout_p), dtype=x.dtype,
                         device=x.device)
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


def dropout_bdt_apply(x: torch.Tensor, seed: int, dropout_p: float,
                      salt: int) -> torch.Tensor:
    """One pass of the mask over x [B, D, T] (forward and backward are the
    same pass).  CPU tensors run ``dropout_bdt_plain``; CUDA tensors launch
    ``csrc/dropout_bdt.cu``."""
    if not _build.use_kernel(x):
        return dropout_bdt_plain(x, seed, dropout_p, salt)
    if x.dim() != 3:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected [B, D, T]")
    _build.check("x", x, x.shape, _DTYPES)
    b, d, t = x.shape
    y = torch.empty_like(x)
    _build.launch(
        "dropout_bdt", x.device, 0 if x.dtype == torch.float32 else 1,
        x.data_ptr(), y.data_ptr(), int(salt),
        *prng.kernel_args(seed, dropout_p), b, d, t)
    return y


class _DropoutBDT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, dropout_p, salt):
        ctx.args = (seed, dropout_p, salt)
        return dropout_bdt_apply(x.contiguous(), seed, dropout_p, salt)

    @staticmethod
    def backward(ctx, g):
        return dropout_bdt_apply(g.contiguous(), *ctx.args), None, None, None


def dropout_bdt(x: torch.Tensor, seed: int, dropout_p: float,
                salt: int) -> torch.Tensor:
    """Inverted dropout on x [B, D, T]: keep with the realised probability
    ``1 - effective_dropout_p(p)`` and scale by its inverse.  ``seed``: a
    Python int (its low 32 bits count).  Differentiable in x."""
    if dropout_p <= 0.0:
        return x
    return _DropoutBDT.apply(x, int(seed), float(dropout_p), int(salt))
