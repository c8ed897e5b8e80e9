"""Tied-embedding output projection and per-token NLL, forward and backward.

PyTorch counterpart of ``commu_tpu/ops/fused_nll.py::fused_token_nll``:
two hand-written CUDA kernels, each with a plain PyTorch twin of the same
signature.

- ``nll_fwd`` (``csrc/nll_fwd.cu``): the NLL, and with ``save=True`` the
  log-normaliser lse [B, T] the backward recomputes probabilities from;
- ``nll_bwd`` (``csrc/nll_bwd.cu``): dh [B, D, T] and the f32 sums d(emb)
  [V, D] and d(bias) [V].

Both run their products on the tensor cores (``csrc/nll_pad.cuh``); the
[B, T, V] logits are never stored, and the backward's dlogits live only in
its workspace.
"""
from __future__ import annotations

import torch

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)


def _logits(hidden_dt, emb, bias):
    return torch.einsum("vd,bdt->btv", emb, hidden_dt.float()) + bias


def nll_fwd_plain(hidden_dt, emb, bias, targets, save: bool = False):
    """Plain twin: hidden_dt [B, D, T] (any float dtype), emb [V, D] and
    bias [V] f32, targets [B, T] int32 -> nll [B, T] f32 (and lse [B, T]
    f32 with ``save``), with the logits emb . h + bias in f32.  A target
    outside [0, V) selects no logit."""
    logits = _logits(hidden_dt, emb, bias)
    m = logits.amax(dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
    v = emb.shape[0]
    inside = (targets >= 0) & (targets < v)
    picked = logits.gather(-1, targets.clamp(0, v - 1).long()[..., None])
    nll = lse - torch.where(inside, picked[..., 0], 0.0)
    return (nll, lse) if save else nll


def nll_fwd(hidden_dt, emb, bias, targets, save: bool = False):
    """The fused projection + NLL on kernel operands (see the plain twin).
    CPU tensors run ``nll_fwd_plain``; CUDA tensors launch
    ``csrc/nll_fwd.cu``."""
    if not _build.use_kernel(hidden_dt, emb, bias, targets):
        return nll_fwd_plain(hidden_dt, emb, bias, targets, save)
    b, d, t = hidden_dt.shape
    v = emb.shape[0]
    _build.check("hidden", hidden_dt, (b, d, t), _DTYPES)
    _build.check("emb", emb, (v, d), (torch.float32,))
    _build.check("bias", bias, (v,), (torch.float32,))
    _build.check("targets", targets, (b, t), (torch.int32,))
    dev = hidden_dt.device
    nll = torch.empty((b, t), dtype=torch.float32, device=dev)
    lse = torch.empty_like(nll) if save else None
    work = _build.workspace("nll_fwd", dev, b, d, t, v)
    _build.launch(
        "nll_fwd", dev, 0 if hidden_dt.dtype == torch.float32 else 1,
        hidden_dt.data_ptr(), emb.data_ptr(), bias.data_ptr(),
        targets.data_ptr(), nll.data_ptr(), lse.data_ptr() if save else None,
        work.data_ptr(), b, d, t, v)
    return (nll, lse) if save else nll


def nll_bwd_plain(hidden_dt, emb, bias, targets, lse, dnll):
    """Plain twin of the backward: the forward's operands, its lse [B, T] and
    the cotangent dnll [B, T] f32 -> (dh [B, D, T] in hidden's dtype,
    demb [V, D] f32, dbias [V] f32).  dlogits = (exp(logits - lse) -
    onehot(target)) * dnll; no PAD mask is assumed."""
    v = emb.shape[0]
    logits = _logits(hidden_dt, emb, bias)
    onehot = torch.nn.functional.one_hot(targets.clamp(0, v - 1).long(), v)
    inside = ((targets >= 0) & (targets < v))[..., None]
    dlogits = (torch.exp(logits - lse[..., None])
               - torch.where(inside, onehot.float(), 0.0)) * dnll[..., None]
    dh = torch.einsum("vd,btv->bdt", emb, dlogits).to(hidden_dt.dtype)
    demb = torch.einsum("btv,bdt->vd", dlogits, hidden_dt.float())
    return dh, demb, dlogits.sum(dim=(0, 1))


def nll_bwd(hidden_dt, emb, bias, targets, lse, dnll):
    """The NLL backward on kernel operands (see the plain twin).  CPU tensors
    run ``nll_bwd_plain``; CUDA tensors launch ``csrc/nll_bwd.cu``."""
    args = (hidden_dt, emb, bias, targets, lse, dnll)
    if not _build.use_kernel(*args):
        return nll_bwd_plain(*args)
    b, d, t = hidden_dt.shape
    v = emb.shape[0]
    _build.check("hidden", hidden_dt, (b, d, t), _DTYPES)
    _build.check("emb", emb, (v, d), (torch.float32,))
    _build.check("bias", bias, (v,), (torch.float32,))
    _build.check("targets", targets, (b, t), (torch.int32,))
    _build.check("lse", lse, (b, t), (torch.float32,))
    _build.check("dnll", dnll, (b, t), (torch.float32,))
    dev = hidden_dt.device
    dh = torch.empty_like(hidden_dt)
    demb = torch.empty((v, d), dtype=torch.float32, device=dev)
    dbias = torch.empty((v,), dtype=torch.float32, device=dev)
    work = _build.workspace("nll_bwd", dev, b, d, t, v)
    _build.launch(
        "nll_bwd", dev, 0 if hidden_dt.dtype == torch.float32 else 1,
        *(x.data_ptr() for x in args), dh.data_ptr(), demb.data_ptr(),
        dbias.data_ptr(), work.data_ptr(), b, d, t, v)
    return dh, demb, dbias


class _FusedTokenNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden_dt, emb, bias, targets):
        hidden_dt = hidden_dt.contiguous()
        emb32 = emb.float().contiguous()
        bias32 = bias.float().contiguous()
        targets = targets.to(torch.int32).contiguous()
        nll, lse = nll_fwd(hidden_dt, emb32, bias32, targets, save=True)
        ctx.save_for_backward(hidden_dt, emb32, bias32, targets, lse)
        ctx.dtypes = (emb.dtype, bias.dtype)
        return nll

    @staticmethod
    def backward(ctx, g):
        hidden_dt, emb32, bias32, targets, lse = ctx.saved_tensors
        dh, demb, dbias = nll_bwd(hidden_dt, emb32, bias32, targets, lse,
                                  g.float().contiguous())
        return dh, demb.to(ctx.dtypes[0]), dbias.to(ctx.dtypes[1]), None


def fused_token_nll(hidden_dt, emb, bias, targets) -> torch.Tensor:
    """Per-token NLL [B, T] f32 through the tied-embedding projection.

    hidden_dt: [B, D, T] (the decoder stack's orientation); emb [V, D] (the
    tied embedding) and bias [V], read in f32 whatever the compute dtype;
    targets [B, T] int.  Equals ``-log_softmax(h^T emb^T + bias)[target]``.
    Differentiable in hidden_dt, emb and bias when autograd asks for it
    (the backward is ``nll_bwd``); otherwise nothing is saved."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (hidden_dt, emb, bias)):
        return _FusedTokenNLL.apply(hidden_dt, emb, bias, targets)
    return nll_fwd(hidden_dt.contiguous(), emb.float().contiguous(),
                   bias.float().contiguous(),
                   targets.to(torch.int32).contiguous())
