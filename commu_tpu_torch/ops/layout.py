"""Memory-layout writes: the decode KV-cache append and the XL-memory ring
slab writes.

PyTorch counterparts of ``commu_tpu/ops/layout.py::cache_append``,
``ring_write_layer`` and ``ring_write``: hand-written CUDA kernels
(``csrc/cache_append.cu``, ``csrc/ring_write_layer.cu``,
``csrc/ring_write.cu``), each with a plain PyTorch twin of the same
signature.  Unlike the reference, which returns new (aliased) arrays, all
versions update the caller's buffers IN PLACE and return them.  The model
writes the ring one layer at a time (``ring_write_layer``, straight from
each layer's activation); ``ring_write`` takes the rows of every stream
stacked, as the reference's does.
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


def ring_write_layer_plain(buf, rows, layer_index: int, block_index: int):
    """Plain twin: ``buf[layer_index, block_index] = rows``, in place."""
    buf[layer_index, block_index].copy_(rows)
    return buf


def ring_write_layer(buf, rows, layer_index: int, block_index: int):
    """Write one layer's rows [B, D, Tb] into slab ``block_index`` (the ring
    head in slabs, head // Tb) of the blocked ring buffer
    buf [L+1, R, B, D, Tb] (the reference's layer_axis=0, ring_axis=1).
    Updates ``buf`` IN PLACE and returns it; values are copied bit for bit.
    CPU tensors run ``ring_write_layer_plain``; CUDA tensors launch
    ``csrc/ring_write_layer.cu``."""
    l1, r_blocks = buf.shape[0], buf.shape[1]
    if not (0 <= layer_index < l1 and 0 <= block_index < r_blocks):
        raise ValueError(f"slab ({layer_index}, {block_index}) outside the "
                         f"buffer's ({l1}, {r_blocks})")
    if not _build.use_kernel(buf, rows):
        return ring_write_layer_plain(buf, rows, layer_index, block_index)
    _build.check("buf", buf, buf.shape, _DTYPES)
    _build.check("rows", rows, buf.shape[2:], (buf.dtype,))
    _build.launch("ring_write_layer", buf.device, buf.element_size(),
                  buf.data_ptr(), rows.data_ptr(), layer_index, block_index,
                  r_blocks, rows.numel())
    return buf


def _ring_write_shapes(buf, rows, block_index: int, axis: int):
    """(outer, inner, R) of the slab write, after checking that ``buf`` is
    ``rows`` with a ring dimension inserted at ``axis``, before the trailing
    [D, T] pair."""
    if rows.dim() < 2 or not 0 <= axis <= rows.dim() - 2:
        raise ValueError(f"axis {axis} must lie before the trailing [D, T] "
                         f"pair of rows {tuple(rows.shape)}")
    lead = tuple(rows.shape)
    r_blocks = buf.shape[axis] if buf.dim() == rows.dim() + 1 else -1
    if tuple(buf.shape) != lead[:axis] + (r_blocks,) + lead[axis:]:
        raise ValueError(f"buf {tuple(buf.shape)} is not rows "
                         f"{tuple(rows.shape)} with a ring dim at {axis}")
    if not 0 <= block_index < r_blocks:
        raise ValueError(f"slab {block_index} outside the ring's {r_blocks}")
    outer = 1
    for n in lead[:axis]:
        outer *= n
    return outer, rows.numel() // max(outer, 1), r_blocks


def ring_write_plain(buf, rows, block_index: int, axis: int):
    """Plain twin: ``buf.select(axis, block_index).copy_(rows)``, in place."""
    _ring_write_shapes(buf, rows, block_index, axis)
    buf.select(axis, block_index).copy_(rows)
    return buf


def ring_write(buf, rows, block_index: int, axis: int):
    """Write the stacked rows of every stream into slab ``block_index`` of a
    blocked ring buffer whose ring dimension sits at ``axis``: e.g. buf
    [L+1, R, B, D, T] with axis 1 and rows [L+1, B, D, T] (``buf`` with the
    ring dim removed).  ``axis`` may be any position before the trailing
    [D, T] pair.  Updates ``buf`` IN PLACE and returns it; values are copied
    bit for bit.  CPU tensors run ``ring_write_plain``; CUDA tensors launch
    ``csrc/ring_write.cu``."""
    outer, inner, r_blocks = _ring_write_shapes(buf, rows, block_index, axis)
    if not _build.use_kernel(buf, rows):
        return ring_write_plain(buf, rows, block_index, axis)
    _build.check("buf", buf, buf.shape, _DTYPES)
    _build.check("rows", rows, rows.shape, (buf.dtype,))
    if outer > 65535:
        raise ValueError(f"{outer} pieces before the ring axis: the kernel "
                         "takes at most 65535")
    if rows.numel():
        _build.launch("ring_write", buf.device, buf.element_size(),
                      buf.data_ptr(), rows.data_ptr(), outer, inner, r_blocks,
                      block_index)
    return buf
