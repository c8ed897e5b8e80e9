"""Fused post-attention block: residual -> post-LN -> position-wise FFN ->
post-LN, forward and backward, with the block's three dropouts.

PyTorch counterpart of ``commu_tpu/ops/fused_ffn.py::ffn_block`` and
``ffn_block_fused_o``: two hand-written CUDA kernels, each with a plain
PyTorch twin of the same signature.

- ``ffn_block_fwd`` (``csrc/ffn_block_fwd.cu``); with ``save=True`` it also
  returns what the backward reads: norm1, norm2 [B, D, T] and h1 [B, F, T]
  in the compute dtype, and the rstds [B, 2, T] f32;
- ``ffn_block_bwd`` (``csrc/ffn_block_bwd.cu``): dx, do (the same tensor
  without dropout) and the f32 parameter gradients dW1 [D, F], db1, dW2
  [F, D], db2, dg1, dbe1, dg2, dbe2.

    z1 = x + drop_O(o);  a = LN1(z1)
    h1 = drop_H(relu(W1^T a + b1));  f = drop_F(W2^T h1 + b2)
    y  = LN2(a + f)

With ``wo`` both take their fuse_o form (``ffn_block_fused_o``;
``COMMU_O_IN_FFN=1`` routes the decoder layer through it, as in the
reference): ``o`` is then the attention vector before its output projection,
vec [B, H*dh, T], and the forward forms o = Wo^T vec itself, Wo [H*dh, D];
the backward returns dvec in do's place and dWo [H*dh, D] f32 after the
other gradients.  That o stays f32 until mask O and the residual, where the
unfused path's was rounded to the compute dtype by the projection outside,
so in bf16 the two paths differ by that rounding; the backward rounds do
before both of its products with it.  Both kernels run the same passes in
either form: the ``wo`` form adds o = Wo^T vec in front of the forward's
products, and dvec = Wo do_c and dWo beside the backward's.

The three masks of batch row b are the planes [D, T], [F, T] and [D, T]
seeded with ``seed + b * 8192 + salt * 2048``, salts O = 0, H = 1, F = 2
(``ops.prng``; the reference's ``_dropout_mask``, ``fused_ffn.py:58-63``).
With dropout the saved h1 carries mask H in its sign, as the reference's
does (h1 where kept, -h1 where dropped: post-ReLU values are >= 0): the
backward reads the ReLU and the mask off one compare and recomputes only
masks O and F from the hash.

Activations are feature-major [B, D, T] (the reference's layer-stack
orientation).  LayerNorm statistics are f32 with the fast variance
max(E[z^2] - mean^2, 0) and eps 1e-5; ``a`` is rounded to the compute dtype
before the W1 product, but the residual a + f uses ``a`` in f32.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from . import _build, prng

LN_EPS = 1e-5
SALT_O, SALT_H, SALT_F = 0, 1, 2
_DTYPES = (torch.float32, torch.bfloat16)


def _normalize(z: torch.Tensor):
    """(norm, rstd [B, T]) of an f32 [B, D, T] tensor over the feature axis
    (dim 1), with the fast variance and eps ``LN_EPS``."""
    d = z.shape[1]
    mean = z.sum(dim=1, keepdim=True) * (1.0 / d)
    sq = (z * z).sum(dim=1, keepdim=True) * (1.0 / d)
    var = torch.clamp(sq - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + LN_EPS)
    return (z - mean) * rstd, rstd[:, 0]


def _ln(z: torch.Tensor, g: torch.Tensor, be: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the feature axis (dim 1) of an f32 [B, D, T] tensor."""
    norm, _ = _normalize(z)
    return norm * g[:, None] + be[:, None]


def _ln_bwd(dy, norm, rstd, g):
    """dz for y = norm * g + be with norm = (z - mean(z)) * rstd (the
    reference's ``_ln_bwd``); [B, D, T] f32, rstd [B, T]."""
    d = norm.shape[1]
    dnorm = dy * g[:, None]
    m1 = dnorm.sum(dim=1, keepdim=True) * (1.0 / d)
    m2 = (dnorm * norm).sum(dim=1, keepdim=True) * (1.0 / d)
    return rstd[:, None] * (dnorm - m1 - norm * m2)


def _masks(seed: int, dropout_p: float, bits, b: int, d: int, f: int, t: int,
           device, salts):
    """The keep masks [B, rows, T] of the named sites at draw width
    ``bits``, and the keep-scale as an f32 scalar tensor."""
    rows = {SALT_O: d, SALT_H: f, SALT_F: d}
    masks = [prng.keep_mask(
        prng.row_seeds(seed, b, 8192, salt * 2048, device=device),
        (rows[salt], t), dropout_p, bits=bits) for salt in salts]
    scale = torch.tensor(prng.keep_scale_for(dropout_p, bits=bits),
                         dtype=torch.float32, device=device)
    return masks, scale


def o_in_ffn() -> bool:
    """COMMU_O_IN_FFN=1 (read at each call, as the reference does): the
    decoder layer hands the attention vector and the o_net weight to
    ``ffn_block_fused_o``, and the output projection runs inside the FFN
    kernels."""
    return os.environ.get("COMMU_O_IN_FFN", "0") == "1"


def ffn_block_fwd_plain(x, o, w1, b1, w2, b2, g1, be1, g2, be2,
                        save: bool = False, seed: int = 0,
                        dropout_p: float = 0.0, wo=None,
                        bits: Optional[int] = None):
    """Plain PyTorch twin of the kernel.  x, o: [B, D, T]; w1 [D, F] and
    w2 [F, D] in x's dtype; b1 [F] and b2, g1, be1, g2, be2 [D] in f32.
    Returns y, or (y, norm1, norm2, h1, stats) with ``save``.  With
    ``dropout_p`` > 0 the three masks of ``seed`` apply, drawn at width
    ``bits`` (8 or 16; ``prng.dropout_bits()`` when None), and the saved h1
    is sign-encoded.  With ``wo`` [HD, D] (x's dtype), ``o`` is the attention
    vector [B, HD, T] and o = Wo^T vec is formed here, in f32."""
    cdt = x.dtype
    drop = dropout_p > 0.0
    o_f = o.float() if wo is None else \
        torch.einsum("cd,bct->bdt", wo.float(), o.float())
    if drop:
        (keep_o, keep_h, keep_f), scale = _masks(
            seed, dropout_p, bits, x.shape[0], x.shape[1], w1.shape[1],
            x.shape[2],
            x.device, (SALT_O, SALT_H, SALT_F))
        o_f = torch.where(keep_o, o_f * scale, 0.0)
    norm1, rstd1 = _normalize(x.float() + o_f)
    a = norm1 * g1[:, None] + be1[:, None]
    h1 = torch.relu(torch.einsum("df,bdt->bft", w1.float(), a.to(cdt).float())
                    + b1[:, None])
    if drop:
        h1_d = torch.where(keep_h, h1 * scale, 0.0).to(cdt)
        h1 = torch.where(keep_h, h1, -h1).to(cdt)
    else:
        h1 = h1_d = h1.to(cdt)
    f = torch.einsum("fd,bft->bdt", w2.float(), h1_d.float()) + b2[:, None]
    if drop:
        f = torch.where(keep_f, f * scale, 0.0)
    norm2, rstd2 = _normalize(a + f)
    y = norm2 * g2[:, None] + be2[:, None]
    if not save:
        return y.to(cdt)
    return (y.to(cdt), norm1.to(cdt), norm2.to(cdt), h1.contiguous(),
            torch.stack([rstd1, rstd2], dim=1))


def ffn_block_fwd(x, o, w1, b1, w2, b2, g1, be1, g2, be2, save: bool = False,
                  seed: int = 0, dropout_p: float = 0.0, wo=None,
                  bits: Optional[int] = None):
    """The fused block on kernel operands (see the plain twin).  CPU tensors
    run ``ffn_block_fwd_plain``; CUDA tensors launch
    ``csrc/ffn_block_fwd.cu`` (counted as ``ffn_block_fused_o_fwd`` in its
    ``wo`` form).

    The kernel runs its two products as tiled ``mma.sync`` products (3xTF32
    in f32, bf16 with f32 sums in bf16) between two LayerNorm passes with one
    lane per token column; the ``wo`` form adds o = Wo^T vec as a third such
    product in front, kept in f32.  The tiles stream the depth, so any D, F
    and HD fit."""
    fuse_o = wo is not None
    tensors = (x, o, w1, b1, w2, b2, g1, be1, g2, be2) + (wo,) * fuse_o
    if not _build.use_kernel(*tensors):
        return ffn_block_fwd_plain(x, o, w1, b1, w2, b2, g1, be1, g2, be2,
                                   save, seed, dropout_p, wo, bits)
    b, d, t = x.shape
    f = w1.shape[1]
    hd = o.shape[1] if fuse_o else 0
    dt = (x.dtype,)
    _build.check("x", x, (b, d, t), _DTYPES)
    _build.check("o", o, (b, hd if fuse_o else d, t), dt)
    if fuse_o:
        _build.check("wo", wo, (hd, d), dt)
    _build.check("w1", w1, (d, f), dt)
    _build.check("w2", w2, (f, d), dt)
    _build.check("b1", b1, (f,), (torch.float32,))
    for name, param in (("b2", b2), ("g1", g1), ("be1", be1), ("g2", g2),
                        ("be2", be2)):
        _build.check(name, param, (d,), (torch.float32,))
    y = torch.empty_like(x)
    saved = (torch.empty_like(x), torch.empty_like(x),
             torch.empty((b, f, t), dtype=x.dtype, device=x.device),
             torch.empty((b, 2, t), dtype=torch.float32, device=x.device)) \
        if save else (None,) * 4
    code = 0 if x.dtype == torch.float32 else 1
    work = _build.workspace("ffn_block_fwd", x.device, code, b, d, f, t, hd)
    drop = prng.kernel_args(seed, dropout_p, bits)
    _build.launch(
        _build.form("ffn_block_fused_o_fwd" if fuse_o else "ffn_block_fwd",
                    False, drop[1], drop[3]), x.device, code, x.data_ptr(),
        o.data_ptr(), wo.data_ptr() if fuse_o else None, w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), g1.data_ptr(),
        be1.data_ptr(), g2.data_ptr(), be2.data_ptr(), y.data_ptr(),
        *(s.data_ptr() if save else None for s in saved),
        work.data_ptr(), b, d, f, t, hd, *drop)
    return (y, *saved) if save else y


def ffn_block_bwd_plain(w1, w2, g1, be1, g2, norm1, norm2, h1, stats, dy,
                        seed: int = 0, dropout_p: float = 0.0, vec=None,
                        wo=None, bits: Optional[int] = None):
    """Plain twin of the backward: the forward's weights (w1 [D, F], w2
    [F, D] in the compute dtype; g1, be1, g2 [D] f32), its saved norm1,
    norm2, h1 and stats, and dy [B, D, T] -> (dx, do [B, D, T] in the
    compute dtype, dw1 [D, F], db1 [F], dw2 [F, D], db2, dg1, dbe1, dg2,
    dbe2 [D], all f32).  Without dropout the attention-output cotangent do
    is dx itself; with it, do is dx under mask O, mask F applies to dz2
    before db2, dW2 and the W2 product (the residual keeps the unmasked
    dz2), and dW2 takes the dropped h1 rebuilt from the sign-encoded one.
    With ``vec`` [B, HD, T] and ``wo`` [HD, D] (the fuse_o form) the second
    output is dvec = Wo do_c [B, HD, T], do_c being do rounded to the
    compute dtype, and dwo = sum vec do_c^T [HD, D] f32 follows dbe2."""
    cdt = dy.dtype
    drop = dropout_p > 0.0
    n1, n2 = norm1.float(), norm2.float()
    rstd1, rstd2 = stats[:, 0], stats[:, 1]
    dyf = dy.float()
    dz2 = _ln_bwd(dyf, n2, rstd2, g2)
    df, h1_d, scale = dz2, h1.float(), 1.0
    if drop:
        b, d, t = dy.shape
        (keep_o, keep_f), scale = _masks(seed, dropout_p, bits, b, d,
                                         w1.shape[1], t, dy.device,
                                         (SALT_O, SALT_F))
        df = torch.where(keep_f, dz2 * scale, 0.0)
        h1_d = (torch.clamp(h1.float(), min=0.0) * scale).to(cdt).float()
    df_c = df.to(cdt).float()
    dh1 = torch.einsum("fd,bdt->bft", w2.float(), df_c)
    dh1 = torch.where(h1.float() > 0.0, dh1 * scale, 0.0)
    dh1_c = dh1.to(cdt).float()
    da = torch.einsum("df,bft->bdt", w1.float(), dh1_c) + dz2
    dz1 = _ln_bwd(da, n1, rstd1, g1)
    a_c = (n1 * g1[:, None] + be1[:, None]).to(cdt).float()
    dx = dz1.to(cdt)
    do = torch.where(keep_o, dz1 * scale, 0.0).to(cdt) if drop else dx
    grads = (torch.einsum("bdt,bft->df", a_c, dh1_c), dh1.sum(dim=(0, 2)),
             torch.einsum("bft,bdt->fd", h1_d, df_c),
             df.sum(dim=(0, 2)), (da * n1).sum(dim=(0, 2)),
             da.sum(dim=(0, 2)), (dyf * n2).sum(dim=(0, 2)),
             dyf.sum(dim=(0, 2)))
    if wo is None:
        return (dx, do, *grads)
    do_c = do.float()
    return (dx, torch.einsum("cd,bdt->bct", wo.float(), do_c).to(cdt), *grads,
            torch.einsum("bct,bdt->cd", vec.float(), do_c))


def ffn_block_bwd(w1, w2, g1, be1, g2, norm1, norm2, h1, stats, dy,
                  seed: int = 0, dropout_p: float = 0.0, vec=None, wo=None,
                  bits: Optional[int] = None):
    """The block's backward on kernel operands (see the plain twin).  CPU
    tensors run ``ffn_block_bwd_plain``; CUDA tensors launch
    ``csrc/ffn_block_bwd.cu`` (counted as ``ffn_block_fused_o_bwd`` in its
    ``wo`` form).

    The kernel is bound by tensor-core arithmetic (8 D F B T operations: the
    products with W2 and W1 and the two weight-gradient sums; the ``wo``
    form adds dvec = Wo do_c and dWo, 4 HD D B T more) and runs each of them
    as a tiled ``mma.sync`` product (3xTF32 in f32, bf16 with f32 sums in
    bf16) between two LayerNorm-backward passes with one lane per token
    column; its tiles stream the depth, so any D, F and HD fit."""
    fuse_o = wo is not None
    if fuse_o != (vec is not None):
        raise ValueError("vec and wo come together (the fuse_o form)")
    args = (w1, w2, g1, be1, g2, norm1, norm2, h1, stats, dy)
    if not _build.use_kernel(*args, *((vec, wo) if fuse_o else ())):
        return ffn_block_bwd_plain(*args, seed, dropout_p, vec, wo, bits)
    b, d, t = dy.shape
    f = w1.shape[1]
    hd = wo.shape[0] if fuse_o else 0
    dt = (dy.dtype,)
    if fuse_o:
        _build.check("vec", vec, (b, hd, t), dt)
        _build.check("wo", wo, (hd, d), dt)
    _build.check("dy", dy, (b, d, t), _DTYPES)
    _build.check("w1", w1, (d, f), dt)
    _build.check("w2", w2, (f, d), dt)
    for name, param in (("g1", g1), ("be1", be1), ("g2", g2)):
        _build.check(name, param, (d,), (torch.float32,))
    _build.check("norm1", norm1, (b, d, t), dt)
    _build.check("norm2", norm2, (b, d, t), dt)
    _build.check("h1", h1, (b, f, t), dt)
    _build.check("stats", stats, (b, 2, t), (torch.float32,))
    dev = dy.device
    dx = torch.empty_like(dy)
    # the second output: dvec (fuse_o), do under mask O (dropout), else dx
    if fuse_o:
        second = torch.empty_like(vec)
    else:
        second = torch.empty_like(dy) if dropout_p > 0.0 else dx
    grads = [torch.empty((d, f), dtype=torch.float32, device=dev),
             torch.empty((f,), dtype=torch.float32, device=dev),
             torch.empty((f, d), dtype=torch.float32, device=dev)] + \
        [torch.empty((d,), dtype=torch.float32, device=dev) for _ in range(5)]
    dwo = torch.empty((hd, d), dtype=torch.float32, device=dev) \
        if fuse_o else None
    work = _build.workspace("ffn_block_bwd", dev,
                            0 if dy.dtype == torch.float32 else 1, b, d, f,
                            t, hd)
    drop = prng.kernel_args(seed, dropout_p, bits)
    _build.launch(
        _build.form("ffn_block_fused_o_bwd" if fuse_o else "ffn_block_bwd",
                    False, drop[1], drop[3]), dev,
        0 if dy.dtype == torch.float32 else 1, *(x.data_ptr() for x in args),
        *(x.data_ptr() if fuse_o else None for x in (vec, wo)), dx.data_ptr(),
        second.data_ptr() if dropout_p > 0.0 and not fuse_o else None,
        second.data_ptr() if fuse_o else None,
        *(g.data_ptr() for g in grads),
        dwo.data_ptr() if fuse_o else None, work.data_ptr(), b, d, f, t, hd,
        *drop)
    return (dx, second, *grads, dwo) if fuse_o else (dx, second, *grads)


class _FFNBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, o, w1, b1, w2, b2, g1, be1, g2, be2, seed,
                dropout_p, bits):
        y, norm1, norm2, h1, stats = ffn_block_fwd(
            x, o, w1, b1, w2, b2, g1, be1, g2, be2, save=True, seed=seed,
            dropout_p=dropout_p, bits=bits)
        ctx.save_for_backward(w1, w2, g1, be1, g2, norm1, norm2, h1, stats)
        ctx.drop = dict(seed=seed, dropout_p=dropout_p, bits=bits)
        return y

    @staticmethod
    def backward(ctx, dy):
        w1, w2, g1, be1, g2, norm1, norm2, h1, stats = ctx.saved_tensors
        dx, do, dw1, db1, dw2, db2, dg1, dbe1, dg2, dbe2 = ffn_block_bwd(
            w1, w2, g1, be1, g2, norm1, norm2, h1, stats,
            dy.to(w1.dtype).contiguous(), **ctx.drop)
        return (dx, do, dw1.to(w1.dtype), db1, dw2.to(w2.dtype), db2, dg1,
                dbe1, dg2, dbe2, None, None, None)


class _FFNBlockFusedO(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, vec, wo, w1, b1, w2, b2, g1, be1, g2, be2, seed,
                dropout_p, bits):
        y, norm1, norm2, h1, stats = ffn_block_fwd(
            x, vec, w1, b1, w2, b2, g1, be1, g2, be2, save=True, seed=seed,
            dropout_p=dropout_p, wo=wo, bits=bits)
        ctx.save_for_backward(w1, w2, g1, be1, g2, norm1, norm2, h1, stats,
                              vec, wo)
        ctx.drop = dict(seed=seed, dropout_p=dropout_p, bits=bits)
        return y

    @staticmethod
    def backward(ctx, dy):
        *saved, vec, wo = ctx.saved_tensors
        w1, w2 = saved[0], saved[1]
        (dx, dvec, dw1, db1, dw2, db2, dg1, dbe1, dg2, dbe2,
         dwo) = ffn_block_bwd(*saved, dy.to(w1.dtype).contiguous(),
                              **ctx.drop, vec=vec, wo=wo)
        return (dx, dvec, dwo.to(wo.dtype), dw1.to(w1.dtype), db1,
                dw2.to(w2.dtype), db2, dg1, dbe1, dg2, dbe2, None, None,
                None)


def ffn_block(x, o, w1, b1, w2, b2, g1, be1, g2, be2, seed: int = 0,
              dropout_p: float = 0.0, train: bool = False,
              bits: Optional[int] = None) -> torch.Tensor:
    """Fused post-attention block.  x, o: [B, D, T] (layer input and o_net
    output, before its dropout); w1 [D, F], w2 [F, D] in the compute dtype
    (x's); the biases and LayerNorm parameters in any float dtype; ``seed``:
    the block's dropout seed, a Python int, read only when ``train`` and
    ``dropout_p`` > 0; ``bits``: the masks' draw width, read from
    ``COMMU_DROPOUT_BITS`` here when None (the backward redraws at the
    forward's).  Returns y [B, D, T].  Differentiable when autograd
    asks for it (the backward is ``ffn_block_bwd``; w1 and w2 get their
    gradients rounded to the compute dtype, the vectors in f32, as in the
    reference)."""
    p = float(dropout_p) if train and dropout_p > 0.0 else 0.0
    bits = prng.dropout_bits() if bits is None else bits
    cdt = x.dtype
    args = (x.contiguous(), o.to(cdt).contiguous(), w1.to(cdt).contiguous(),
            b1.float().contiguous(), w2.to(cdt).contiguous(),
            *(p.float().contiguous() for p in (b2, g1, be1, g2, be2)))
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _FFNBlock.apply(*args, int(seed), p, bits)
    return ffn_block_fwd(*args, seed=int(seed), dropout_p=p, bits=bits)


def ffn_block_fused_o(x, vec, wo, w1, b1, w2, b2, g1, be1, g2, be2,
                      seed: int = 0, dropout_p: float = 0.0,
                      train: bool = False,
                      bits: Optional[int] = None) -> torch.Tensor:
    """``ffn_block`` with the attention output projection inside: ``vec``
    [B, HD, T] is the attention vector before it (heads flattened: a free
    reshape of the attention kernels' [B, H, dh, T] output) and ``wo``
    [HD, D] the o_net weight, input-major.  The forward forms o = Wo^T vec
    in the kernel; the backward returns d(vec) and dWo.  The rest as
    ``ffn_block``.  Returns y [B, D, T]."""
    p = float(dropout_p) if train and dropout_p > 0.0 else 0.0
    bits = prng.dropout_bits() if bits is None else bits
    cdt = x.dtype
    args = (x.contiguous(), vec.to(cdt).contiguous(),
            wo.to(cdt).contiguous(), w1.to(cdt).contiguous(),
            b1.float().contiguous(), w2.to(cdt).contiguous(),
            *(v.float().contiguous() for v in (b2, g1, be1, g2, be2)))
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _FFNBlockFusedO.apply(*args, int(seed), p, bits)
    x, vec, wo, *rest = args
    return ffn_block_fwd(x, vec, *rest, seed=int(seed), dropout_p=p, wo=wo,
                         bits=bits)
