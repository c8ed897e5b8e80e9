"""Scaled token-embedding lookup in the layer stack's [B, D, T] orientation,
with a hand-written backward.

PyTorch counterpart of ``commu_tpu/ops/embed.py::embed_bdt``: the forward is
the gather ``(emb[tokens] * scale)`` cast to the compute dtype and turned
feature-major; the backward is the embedding gradient
``csrc/embed_grad.cu`` (or its plain twin for CPU tensors),

    demb[v] = scale * sum over (b, t) with tokens[b, t] == v of g[b, :, t]

accumulated in f32.  PAD tokens count like any other.
"""
from __future__ import annotations

import torch

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)


def embed_grad_plain(tokens, g, scale: float, vocab: int):
    """Plain twin: tokens [B, T] int32, g [B, D, T] (any float dtype) ->
    demb [V, D] f32 = scale * the per-token sums of g."""
    d = g.shape[1]
    rows = g.float().transpose(1, 2).reshape(-1, d)
    demb = torch.zeros((vocab, d), dtype=torch.float32, device=g.device)
    demb.index_add_(0, tokens.reshape(-1).long(), rows)
    return demb * scale


def embed_grad(tokens, g, scale: float, vocab: int):
    """The embedding gradient on kernel operands (see the plain twin).  CPU
    tensors run ``embed_grad_plain``; CUDA tensors launch
    ``csrc/embed_grad.cu``."""
    if not _build.use_kernel(tokens, g):
        return embed_grad_plain(tokens, g, scale, vocab)
    b, d, t = g.shape
    _build.check("tokens", tokens, (b, t), (torch.int32,))
    _build.check("g", g, (b, d, t), _DTYPES)
    if d > 2048:
        raise ValueError(f"D={d}: the kernel takes at most 2048 features")
    if not 1 <= vocab <= 10240:
        raise ValueError(f"V={vocab}: the kernel takes 1 to 10240 tokens")
    demb = torch.empty((vocab, d), dtype=torch.float32, device=g.device)
    work = _build.workspace("embed_grad", g.device, b, d, t, vocab)
    _build.launch("embed_grad", g.device, 0 if g.dtype == torch.float32 else 1,
                  tokens.data_ptr(), g.data_ptr(), demb.data_ptr(),
                  work.data_ptr(), b, d, t, vocab, float(scale))
    return demb


class _EmbedBDT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb, tokens, scale, dtype):
        ctx.save_for_backward(tokens)
        ctx.scale, ctx.vocab, ctx.emb_dtype = scale, emb.shape[0], emb.dtype
        x = emb[tokens.long()] * torch.tensor(scale, dtype=emb.dtype)
        return x.to(dtype).transpose(1, 2).contiguous()

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        demb = embed_grad(tokens, g.contiguous(), ctx.scale, ctx.vocab)
        return demb.to(ctx.emb_dtype), None, None, None


def embed_bdt(emb: torch.Tensor, tokens: torch.Tensor, scale: float,
              dtype: torch.dtype) -> torch.Tensor:
    """[B, D, T] scaled embedding lookup, ``(emb[tokens] * scale)^T`` per row
    in ``dtype``; emb [V, D] (f32 parameters), tokens [B, T] int.  Its
    gradient with respect to ``emb`` is f32."""
    tokens = tokens.to(torch.int32).contiguous()
    if torch.is_grad_enabled() and emb.requires_grad:
        return _EmbedBDT.apply(emb, tokens, float(scale), dtype)
    x = emb[tokens.long()] * torch.tensor(scale, dtype=emb.dtype)
    return x.to(dtype).transpose(1, 2).contiguous()
