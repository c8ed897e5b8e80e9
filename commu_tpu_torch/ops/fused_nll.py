"""Tied-embedding output projection and per-token NLL, forward.

PyTorch counterpart of ``commu_tpu/ops/fused_nll.py::fused_token_nll``
(forward): a hand-written CUDA kernel (``csrc/nll_fwd.cu``) and a plain
PyTorch twin of the same signature.  The [B, T, V] logits are never stored.
"""
from __future__ import annotations

import torch

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)


def nll_fwd_plain(hidden_dt, emb, bias, targets):
    """Plain twin: hidden_dt [B, D, T] (any float dtype), emb [V, D] and
    bias [V] f32, targets [B, T] int32 -> nll [B, T] f32, with the logits
    emb . h + bias in f32.  A target outside [0, V) selects no logit."""
    logits = torch.einsum("vd,bdt->btv", emb, hidden_dt.float()) + bias
    m = logits.amax(dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
    v = emb.shape[0]
    inside = (targets >= 0) & (targets < v)
    picked = logits.gather(-1, targets.clamp(0, v - 1).long()[..., None])
    return lse - torch.where(inside, picked[..., 0], 0.0)


def nll_fwd(hidden_dt, emb, bias, targets):
    """The fused projection + NLL on kernel operands (see the plain twin).
    CPU tensors run ``nll_fwd_plain``; CUDA tensors launch
    ``csrc/nll_fwd.cu``."""
    if not _build.use_kernel(hidden_dt, emb, bias, targets):
        return nll_fwd_plain(hidden_dt, emb, bias, targets)
    b, d, t = hidden_dt.shape
    v = emb.shape[0]
    _build.check("hidden", hidden_dt, (b, d, t), _DTYPES)
    _build.check("emb", emb, (v, d), (torch.float32,))
    _build.check("bias", bias, (v,), (torch.float32,))
    _build.check("targets", targets, (b, t), (torch.int32,))
    if 4 * 8 * (d + 1 + v) > 232448:
        raise ValueError(f"D={d}, V={v} exceed the kernel's shared memory")
    nll = torch.empty((b, t), dtype=torch.float32, device=hidden_dt.device)
    _build.launch(
        "nll_fwd", hidden_dt.device,
        0 if hidden_dt.dtype == torch.float32 else 1, hidden_dt.data_ptr(),
        emb.data_ptr(), bias.data_ptr(), targets.data_ptr(), nll.data_ptr(),
        b, d, t, v)
    return nll


def fused_token_nll(hidden_dt, emb, bias, targets) -> torch.Tensor:
    """Per-token NLL [B, T] f32 through the tied-embedding projection.

    hidden_dt: [B, D, T] (the decoder stack's orientation); emb [V, D] (the
    tied embedding) and bias [V], read in f32 whatever the compute dtype;
    targets [B, T] int.  Equals ``-log_softmax(h^T emb^T + bias)[target]``."""
    return nll_fwd(hidden_dt.contiguous(), emb.float().contiguous(),
                   bias.float().contiguous(),
                   targets.to(torch.int32).contiguous())
