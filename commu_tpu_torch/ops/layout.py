"""Decode KV-cache append.

PyTorch counterpart of ``commu_tpu/ops/layout.py::cache_append``: a
hand-written CUDA kernel (``csrc/cache_append.cu``) and a plain PyTorch twin
of the same signature.  Unlike the reference, which returns new (aliased)
arrays, both versions update the caller's ``k`` and ``v`` IN PLACE and
return them.
"""
from __future__ import annotations

import torch

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)


def cache_append_plain(k, v, k_self, v_self, length, advance):
    """Plain twin: gather each row's slot at ``length`` (clamped into
    range), select the self K/V where the row writes, scatter back.  A row
    at capacity rewrites its last slot with its own value (no change)."""
    l_dim, g_dim, h, dh, m_cap = k.shape
    write = (advance & (length >= 0) & (length < m_cap))
    write = write[None, :, None, None, None]
    pos = length.clamp(0, m_cap - 1).long()[None, :, None, None, None]
    pos = pos.expand(l_dim, g_dim, h, dh, 1)
    for buf, new in ((k, k_self), (v, v_self)):
        cur = buf.gather(4, pos)
        buf.scatter_(4, pos, torch.where(write, new[..., None].to(buf.dtype),
                                         cur))
    return k, v


def cache_append(k, v, k_self, v_self, length, advance):
    """Write ``k_self``/``v_self`` [L, G, H, dh] at lane ``length[g]`` of
    the cache ``k``/``v`` [L, G, H, dh, M] for every row g with
    ``advance[g]`` and ``length[g] < M``; other rows are untouched.  Updates
    ``k`` and ``v`` in place and returns them.  CPU tensors run
    ``cache_append_plain``; CUDA tensors launch ``csrc/cache_append.cu``."""
    if not _build.use_kernel(k, v, k_self, v_self, length, advance):
        return cache_append_plain(k, v, k_self, v_self, length, advance)
    l_dim, g_dim, h, dh, m_cap = k.shape
    dt = (k.dtype,)
    k_self = k_self.to(k.dtype).contiguous()
    v_self = v_self.to(k.dtype).contiguous()
    _build.check("k", k, k.shape, _DTYPES)
    _build.check("v", v, k.shape, dt)
    _build.check("k_self", k_self, (l_dim, g_dim, h, dh), dt)
    _build.check("v_self", v_self, (l_dim, g_dim, h, dh), dt)
    _build.check("length", length, (g_dim,), (torch.int32,))
    _build.check("advance", advance, (g_dim,), (torch.bool,))
    _build.launch(
        "cache_append", k.device, k.element_size(), k.data_ptr(),
        v.data_ptr(), k_self.data_ptr(), v_self.data_ptr(), length.data_ptr(),
        advance.data_ptr(), l_dim, g_dim, h * dh, m_cap)
    return k, v
