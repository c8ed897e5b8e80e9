"""Fused post-attention block forward: residual -> post-LN -> position-wise
FFN -> post-LN, in eval mode.

PyTorch counterpart of ``commu_tpu/ops/fused_ffn.py::ffn_block`` (forward,
``train=False``): a hand-written CUDA kernel (``csrc/ffn_block_fwd.cu``)
and a plain PyTorch twin of the same signature.

    z1 = x + o;  a = LN1(z1)
    h1 = relu(W1^T a + b1);  f = W2^T h1 + b2
    y  = LN2(a + f)

Activations are feature-major [B, D, T] (the reference's layer-stack
orientation).  LayerNorm statistics are f32 with the fast variance
max(E[z^2] - mean^2, 0) and eps 1e-5; ``a`` is rounded to the compute dtype
before the W1 product, but the residual a + f uses ``a`` in f32.
"""
from __future__ import annotations

import torch

from . import _build

LN_EPS = 1e-5
_DTYPES = (torch.float32, torch.bfloat16)


def _ln(z: torch.Tensor, g: torch.Tensor, be: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the feature axis (dim 1) of an f32 [B, D, T] tensor."""
    d = z.shape[1]
    mean = z.sum(dim=1, keepdim=True) * (1.0 / d)
    sq = (z * z).sum(dim=1, keepdim=True) * (1.0 / d)
    var = torch.clamp(sq - mean * mean, min=0.0)
    norm = (z - mean) * torch.rsqrt(var + LN_EPS)
    return norm * g[:, None] + be[:, None]


def ffn_block_fwd_plain(x, o, w1, b1, w2, b2, g1, be1, g2, be2):
    """Plain PyTorch twin of the kernel.  x, o: [B, D, T]; w1 [D, F] and
    w2 [F, D] in x's dtype; b1 [F] and b2, g1, be1, g2, be2 [D] in f32."""
    cdt = x.dtype
    a = _ln(x.float() + o.float(), g1, be1)
    h1 = torch.relu(torch.einsum("df,bdt->bft", w1.float(), a.to(cdt).float())
                    + b1[:, None])
    f = torch.einsum("fd,bft->bdt", w2.float(), h1.to(cdt).float()) \
        + b2[:, None]
    return _ln(a + f, g2, be2).to(cdt)


def ffn_block_fwd(x, o, w1, b1, w2, b2, g1, be1, g2, be2):
    """The fused block on kernel operands (see the plain twin).  CPU tensors
    run ``ffn_block_fwd_plain``; CUDA tensors launch
    ``csrc/ffn_block_fwd.cu``."""
    if not _build.use_kernel(x, o, w1, b1, w2, b2, g1, be1, g2, be2):
        return ffn_block_fwd_plain(x, o, w1, b1, w2, b2, g1, be1, g2, be2)
    b, d, t = x.shape
    f = w1.shape[1]
    dt = (x.dtype,)
    _build.check("x", x, (b, d, t), _DTYPES)
    _build.check("o", o, (b, d, t), dt)
    _build.check("w1", w1, (d, f), dt)
    _build.check("w2", w2, (f, d), dt)
    _build.check("b1", b1, (f,), (torch.float32,))
    for name, vec in (("b2", b2), ("g1", g1), ("be1", be1), ("g2", g2),
                      ("be2", be2)):
        _build.check(name, vec, (d,), (torch.float32,))
    if 4 * (8 * d + 4 * f) > 232448:
        raise ValueError(f"D={d}, F={f} exceed the kernel's shared memory")
    y = torch.empty_like(x)
    _build.launch(
        "ffn_block_fwd", x.device, 0 if x.dtype == torch.float32 else 1,
        x.data_ptr(), o.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), g1.data_ptr(), be1.data_ptr(),
        g2.data_ptr(), be2.data_ptr(), y.data_ptr(), b, d, f, t)
    return y


def ffn_block(x, o, w1, b1, w2, b2, g1, be1, g2, be2, dropout_p: float = 0.0,
              train: bool = False) -> torch.Tensor:
    """Fused post-attention block.  x, o: [B, D, T] (layer input and o_net
    output); w1 [D, F], w2 [F, D] in the compute dtype (x's); the biases and
    LayerNorm parameters in any float dtype.  Returns y [B, D, T]."""
    if train and dropout_p > 0.0:
        raise NotImplementedError("FFN-block dropout (training) is not ported")
    cdt = x.dtype
    vecs = [p.float().contiguous() for p in (b1, b2, g1, be1, g2, be2)]
    b1, b2, g1, be1, g2, be2 = vecs
    return ffn_block_fwd(x.contiguous(), o.to(cdt).contiguous(),
                         w1.to(cdt).contiguous(), b1, w2.to(cdt).contiguous(),
                         b2, g1, be1, g2, be2)
