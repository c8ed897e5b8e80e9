"""Relative-position attention, forward and backward: over the window alone
(prefill, and training without XL memory) and over a blocked-ring XL memory
(evaluation and training).

PyTorch counterpart of ``commu_tpu/ops/fused_attention.py``: the prep
tables (trig factors, packed position projection, ring-ordered key basis,
additive mask, scaled biases) as plain torch, and six hand-written CUDA
kernels, each with a plain PyTorch twin of the same signature:

- ``rel_attention_fwd`` (``csrc/rel_attention_fwd.cu``): the window only;
  with ``save=True`` it also returns the backward's residual, the masked
  f32 scores S [B, H, T, T] and each row's log-sum-exp [B, H, T];
- ``rel_attention_bwd`` (``csrc/rel_attention_bwd.cu``): its backward: dq,
  dk, dv, and the f32 gradients dW_r [H, dh, 2F] and the two bias gradients
  [H, dh];
- ``project_mem_kv`` (``csrc/project_mem_kv.cu``): one layer's memory K/V
  projection, read from the ring buffer by layer index;
- ``rel_attention_mem_fwd`` (``csrc/rel_attention_mem_fwd.cu``): attention
  over [ring slabs | window]; with ``save=True`` the residual too
  (S [B, H, T, K] and the log-sum-exp);
- ``rel_attention_proj_fwd`` (``csrc/rel_attention_proj_fwd.cu``): the two
  before it in one kernel, from the raw ring: the output, the projected
  slabs (which the backward reuses) and, with ``save=True``, the residual.
  ``COMMU_PROJ_IN_FWD=1`` (``proj_in_fwd``) routes ``attention_mem``
  through it, as in the reference;
- ``rel_attention_mem_bwd`` (``csrc/rel_attention_mem_bwd.cu``): the memory
  attention's backward: dq, the window's dk and dv, and the f32 weight
  gradients dWk, dWv [H, dh, D], dW_r [H, dh, 2F] and the two bias
  gradients [H, dh].  The memory gets no gradient (it is stop-gradient, as
  in the reference).

``attention`` and ``attention_mem`` differentiate through autograd
``Function``s whose backwards are those kernels.

Attention dropout (training): head h of batch row b draws the plane [T, K]
in ring coordinates, memory columns first, seeded with ``seed + b * 4096 + h``
(``ops.prng``; the reference's ``_attn_softmax``, ``fused_attention.py:
621-638``).  The kept probabilities are scaled before they are rounded to
the compute dtype.  The backward recomputes the mask from the hash (its
residual is S and the row log-sum-exp, not the reference's sign-encoded
probabilities): dv takes the dropped probabilities, and ds = probs dP -
P rowsum(probs dP), so a dropped position still gets the -P rowsum term.
Every forward and backward takes the mask, drawn at the width ``bits`` (8
or 16, ``prng.dropout_bits()``); an autograd ``Function`` redraws in its
backward at the width its forward drew with.

Two more of the reference's numerics modes, both read at each call of
``attention`` / ``attention_mem``:

- ``COMMU_BD_INT8=1`` (``bd_int8``; ``_bd_matmul``, ``fused_attention.py:
  486-499``): the forward's BD product runs on int8 operands.  psi is
  quantised once per call at the fixed scale 1/127 (``quantize_psi_int8``)
  and reaches the forward as the extra operand ``psi_q``; phi, unrounded, is
  quantised per query row by its absolute maximum inside the kernel
  (``quantize_phi_rows``); the int32 sum is exact and is scaled back in f32.
  Evaluation windows run it too: the flag does not depend on ``train``.
- ``COMMU_BD_INT8_BWD=1`` (``bd_int8_bwd``; ``_bwd_stage_b``, :975-984): the
  backward's dphi = ds psi^T runs on int8 operands: the unrounded ds is
  quantised per query row by its absolute maximum over all K keys
  (``quantize_ds_rows``), psi is ``psi_q`` again.  Only the copy of ds that
  enters this product is quantised: dk, dv and the content part of dq are
  those of the exact mode.

The BD (query-position) term is computed through the angle-addition
factorization of the sinusoid, as in the reference: with u = qr^T W_r,

    BD[i, j] = u[i] . emb(M + i - j) = phi(i) . psi(j)

where phi rotates u by per-query trig factors (``query_trig_table``) and psi
is the per-key trig basis (``key_trig_basis``).  Layouts follow the
reference's kernel operands: q, k, v and the output are [B, H, dh, T].
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from . import _build, prng

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
_DTYPES = (torch.float32, torch.bfloat16)


def _fpad(d_model: int) -> int:
    """Frequency padding: the d_model/2 frequencies are padded to a multiple
    of 128 so the sin and cos halves split at a fixed offset (250 -> 256 for
    d_model 500)."""
    half = d_model // 2
    return max(128, -(-half // 128) * 128)


def _inv_freq(d_model: int, device=None) -> torch.Tensor:
    """Reference frequencies 1/10000^(2f/d), f = 0..d/2-1 (f32)."""
    return 1.0 / (10000.0 ** (
        torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
        / d_model))


def query_trig_table(t: int, m_cap: int, d_model: int,
                     dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """trig_a [T, 2F]: per-query factors [sin(w(M+i)) | cos(w(M+i))], each
    half zero-padded to F = _fpad(d_model)."""
    a = torch.arange(t, dtype=torch.float32, device=device) + float(m_cap)
    ang = torch.outer(a, _inv_freq(d_model, device))
    pad = _fpad(d_model) - ang.shape[1]
    return torch.cat([torch.nn.functional.pad(torch.sin(ang), (0, pad)),
                      torch.nn.functional.pad(torch.cos(ang), (0, pad))],
                     dim=1).to(dtype)


def key_trig_basis(k_len: int, d_model: int, dtype=torch.bfloat16,
                   device=None) -> torch.Tensor:
    """psi [2F, K]: per-key basis [cos(w j) ; sin(w j)] over right-aligned
    key indices j."""
    j = torch.arange(k_len, dtype=torch.float32, device=device)
    ang = torch.outer(_inv_freq(d_model, device), j)
    pad = _fpad(d_model) - ang.shape[0]
    return torch.cat([torch.nn.functional.pad(torch.cos(ang), (0, 0, 0, pad)),
                      torch.nn.functional.pad(torch.sin(ang), (0, 0, 0, pad))],
                     dim=0).to(dtype)


def ring_psi(psi_logical: torch.Tensor, t: int, mem_count: int,
             head: int) -> torch.Tensor:
    """Permute psi's memory columns from right-aligned logical order into
    ring order (slot j holds logical token l = (j - start) mod M; its
    right-aligned index is M - count + l).  Empty slots (l >= count) point
    out of range and are clipped: their scores are masked anyway."""
    k_len = psi_logical.shape[1]
    m_cap = k_len - t
    if m_cap == 0:
        return psi_logical
    start = (head - mem_count) % m_cap
    l = torch.remainder(torch.arange(m_cap, device=psi_logical.device) - start,
                        m_cap)
    idx = (m_cap - mem_count + l).clamp(0, k_len - 1)
    return torch.cat([psi_logical[:, idx], psi_logical[:, m_cap:]], dim=1)


def pack_r_kernel(r_kernel: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Position projection [d_model, H*dh] (input-major, as the reference's
    ``r_net`` kernel) -> W_r [H, dh, 2F]: transposed, with the sin rows
    (e < d/2) and the cos rows each zero-padded to F."""
    d_model = r_kernel.shape[0]
    half = d_model // 2
    wrt = r_kernel.reshape(d_model, num_heads, -1).permute(1, 2, 0)
    pad = _fpad(d_model) - half
    return torch.cat([torch.nn.functional.pad(wrt[..., :half], (0, pad)),
                      torch.nn.functional.pad(wrt[..., half:], (0, pad))],
                     dim=2).contiguous()


def build_mask_bias(t: int, m_cap: int, mem_count: int, head: int,
                    same_length: bool, dtype=torch.bfloat16,
                    device=None) -> torch.Tensor:
    """Additive attention mask [2, T, M+T] in ring coordinates: index 0 for
    normal rows (causal window, empty ring slots, optional same_length
    blocking), index 1 for reset rows (every memory column blocked too)."""
    k_len = m_cap + t
    i = torch.arange(t, device=device)[:, None].expand(t, k_len)
    j = torch.arange(k_len, device=device)[None, :].expand(t, k_len)
    mem_col = j < m_cap
    if m_cap > 0:
        start = (head - mem_count) % m_cap
        l = torch.remainder(j - start, m_cap)
    else:
        l = j
    blocked = (~mem_col) & (j >= m_cap + i + 1)
    blocked |= mem_col & (l >= mem_count)
    if same_length:
        mask_len = mem_count + t - m_cap
        shift = t - max(mask_len, 0)
        blocked |= mem_col & (l <= i - shift)
    normal = torch.where(blocked, NEG_INF, 0.0)
    reset_row = torch.where(blocked | mem_col, NEG_INF, 0.0)
    return torch.stack([normal, reset_row]).to(dtype)


def _scaled_biases(r_w_bias: torch.Tensor, r_r_bias: torch.Tensor,
                   scale: float, dtype):
    """Bias operands of the in-kernel query fold: [H, dh, 1] blocks of
    bias * scale in the compute dtype."""
    rwbs = (r_w_bias.float() * scale).to(dtype)[..., None].contiguous()
    rrbs = (r_r_bias.float() * scale).to(dtype)[..., None].contiguous()
    return rwbs, rrbs


def _query_streams(q, rwbs, rrbs, scale: float):
    """(qw, qr) f32 [B, H, dh, T]: q*scale + bias*scale, rounded where the
    reference rounds them (q*scale and each sum, in q's dtype)."""
    qs = q * torch.tensor(scale, dtype=q.dtype)
    return (qs + rwbs).float(), (qs + rrbs).float()


def bd_int8() -> bool:
    """COMMU_BD_INT8=1 (read at each call, as the reference does): the
    forward's BD product on int8 operands."""
    return os.environ.get("COMMU_BD_INT8", "0") == "1"


def bd_int8_bwd() -> bool:
    """COMMU_BD_INT8_BWD=1 (read at each call): the backward's dphi product
    on int8 operands."""
    return os.environ.get("COMMU_BD_INT8_BWD", "0") == "1"


def quantize_psi_int8(psi: torch.Tensor) -> torch.Tensor:
    """psi [2F, K] -> int8 at the fixed scale 1/127, clipped to +-127 (the
    reference's ``quantize_psi_int8``; a psi under dropout exceeds 1)."""
    return torch.clamp(torch.round(psi.float() * 127.0), -127, 127).to(
        torch.int8)


def quantize_phi_rows(phi: torch.Tensor):
    """The forward's in-kernel quantiser (``_bd_matmul``): phi [.., T, 2F]
    f32, not rounded to the compute dtype -> (phi_q int8, amax [.., T, 1]
    f32): phi_q = round(phi * (127 / max(amax, 1e-20))), half to even.  BD
    is then int32(phi_q psi_q) * (amax * (1 / (127 * 127)))."""
    amax = phi.abs().amax(dim=-1, keepdim=True)
    # a true division: ``127.0 / tensor`` is reciprocal-then-multiply in
    # torch, which rounds twice
    qscale = torch.full_like(amax, 127.0) / torch.clamp(amax, min=1e-20)
    return torch.round(phi * qscale).to(torch.int8), amax


def quantize_ds_rows(ds: torch.Tensor):
    """The backward's in-kernel quantiser (``_bwd_stage_b``): ds [.., T, K]
    f32, not rounded -> (ds_q int8, sc [.., T, 1] f32) with sc =
    max(amax, 1e-30) * (1 / 127) and ds_q = round(ds * (1 / sc)).  dphi is
    then int32(ds_q psi_q^T) * (sc * (1 / 127))."""
    amax = ds.abs().amax(dim=-1, keepdim=True)
    sc = torch.clamp(amax, min=1e-30) * (1.0 / 127.0)
    return torch.round(ds * torch.reciprocal(sc)).to(torch.int8), sc


def _int_matmul(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """The exact integer product of two int8 tensors, as f32 (what the
    reference's ``astype(float32)`` of the int32 sum gives).  int32 on the
    CPU; on a CUDA tensor, where the integer matmul has no kernel, in f64,
    which holds every partial sum (at most 127 * 127 * K) exactly."""
    if a_q.device.type == "cpu":
        return (a_q.to(torch.int32) @ b_q.to(torch.int32)).float()
    return (a_q.double() @ b_q.double()).float()


def _scores_plain(q, rwbs, rrbs, k, w_r, trig_a, psi, mask, reset,
                  scale: float, psi_q=None) -> torch.Tensor:
    """The masked f32 score plane S [B, H, T, K] = qw^T k + phi psi + mask;
    with ``psi_q`` (int8 [2F, K]) the BD term is the int8 product."""
    dt = q.dtype
    qw, qr = _query_streams(q, rwbs, rrbs, scale)
    ac = torch.einsum("bhdi,bhdj->bhij", qw, k.float())
    u = torch.einsum("bhdi,hdf->bhif", qr, w_r.float())
    f = u.shape[-1] // 2
    u_s, u_c = u[..., :f], u[..., f:]
    s_a, c_a = trig_a[:, :f].float(), trig_a[:, f:].float()
    phi = torch.cat([u_s * s_a + u_c * c_a, u_c * s_a - u_s * c_a], dim=-1)
    if psi_q is None:
        bd = phi.to(dt).float() @ psi.float()
    else:
        phi_q, amax = quantize_phi_rows(phi)
        bd = _int_matmul(phi_q, psi_q) * (amax * (1.0 / (127.0 * 127.0)))
    return ac + bd + mask.float()[reset.long()][:, None]


def _attention_keep(seed: int, dropout_p: float, bits, b: int, h: int,
                    t: int, k_len: int, device):
    """(keep [B, H, T, K] bool, keep-scale f32 scalar) of the attention
    planes of ``seed`` at draw width ``bits``."""
    seeds = prng.row_seeds(seed, b, 4096, device=device)[:, None] + \
        torch.arange(h, dtype=torch.int64, device=device)
    scale = torch.tensor(prng.keep_scale_for(dropout_p, bits=bits),
                         dtype=torch.float32, device=device)
    return prng.keep_mask(seeds, (t, k_len), dropout_p, bits=bits), scale


def rel_attention_fwd_plain(q, rwbs, rrbs, k, v, w_r, trig_a, psi, mask,
                            reset, scale: float, save: bool = False,
                            seed: int = 0, dropout_p: float = 0.0,
                            bits: Optional[int] = None, psi_q=None):
    """Plain PyTorch twin of the kernel: same operands, same roundings.

    q: [B, H, dh, T]; k, v: [B, H, dh, K] (K = T with no memory);
    rwbs, rrbs: [H, dh, 1]; w_r: [H, dh, 2F]; trig_a: [T, 2F]; psi: [2F, K];
    mask: [2, T, K] bf16; reset: [B] int32.
    Products accumulate in f32; in bf16 mode q*scale, qw, qr, phi and the
    probabilities are rounded to bf16 where the reference rounds them.
    ``save``: also the masked scores S [B, H, T, K] and the rows'
    log-sum-exp [B, H, T], both f32.  ``dropout_p`` > 0 drops the
    normalised probabilities with the masks of ``seed``, drawn at width
    ``bits`` (8 or 16; ``prng.dropout_bits()`` when None), and scales the
    kept ones, before the rounding.  ``psi_q`` (int8 [2F, K],
    ``quantize_psi_int8(psi)``) selects the int8 BD product; phi then stays
    unrounded until its own quantiser."""
    dt = q.dtype
    s = _scores_plain(q, rwbs, rrbs, k, w_r, trig_a, psi, mask, reset, scale,
                      psi_q)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    p = e * (1.0 / denom)
    if dropout_p > 0.0:
        keep, keep_scale = _attention_keep(seed, dropout_p, bits, *s.shape,
                                           s.device)
        p = torch.where(keep, p * keep_scale, 0.0)
    p = p.to(dt).float()
    out = torch.einsum("bhdj,bhij->bhdi", v.float(), p).to(dt)
    if not save:
        return out
    return out, s, (m + torch.log(denom))[..., 0]


def _words_along_depth(psi_q: torch.Tensor) -> torch.Tensor:
    """psi_q int8 [2F, K] -> [2F/4, K, 4]: one 32-bit word per (four depth
    rows, key), what the forward kernels read (``mma.sync`` s8 in the
    tensor-core body, ``__dp4a`` in the FMA bodies; the contraction runs over
    2F)."""
    f2, k_len = psi_q.shape
    return psi_q.reshape(f2 // 4, 4, k_len).permute(0, 2, 1).contiguous()


def _words_along_keys(psi_q: torch.Tensor) -> torch.Tensor:
    """psi_q int8 [2F, K] -> [ceil(K/4), 2F, 4]: one 32-bit word per (four
    keys, depth row), zero-padded, what the backward's ``__dp4a`` reads (the
    contraction of dphi runs over K)."""
    f2, k_len = psi_q.shape
    padded = torch.nn.functional.pad(psi_q, (0, -k_len % 4))
    return padded.reshape(f2, -1, 4).permute(1, 0, 2).contiguous()


def fwd_on_tensor_cores(dh: int, f2: int) -> bool:
    """Whether ``rel_attention_fwd`` runs its tensor-core body at these
    widths (#2's, ``csrc/rel_attention_fwd_mma.cuh``), as the kernel
    library's launch decides (``ModelConfig()``'s widths do).  Every other
    width runs the memory forward's FMA body over the window.  Both take
    any T."""
    return bool(_build.library().commu_rel_attention_fwd_on_tensor_cores(
        dh, f2))


def rel_attention_fwd(q, rwbs, rrbs, k, v, w_r, trig_a, psi, mask, reset,
                      scale: float, save: bool = False, seed: int = 0,
                      dropout_p: float = 0.0, bits: Optional[int] = None,
                      psi_q=None):
    """The attention core on kernel-layout operands (see the plain twin for
    shapes).  Returns out [B, H, dh, T], or with ``save`` (out, S, lse): the
    backward's residual, f32 scores [B, H, T, T] (mask included) and row
    log-sum-exps [B, H, T].  CPU tensors run ``rel_attention_fwd_plain``;
    CUDA tensors launch ``csrc/rel_attention_fwd.cu``: its tensor-core body
    where ``fwd_on_tensor_cores`` says so, else the memory forward's FMA
    body over the window (dh up to 128; any T)."""
    int8 = psi_q is not None
    if not _build.use_kernel(q, k, v, w_r, trig_a, psi, mask, reset,
                             *((psi_q,) if int8 else ())):
        return rel_attention_fwd_plain(q, rwbs, rrbs, k, v, w_r, trig_a, psi,
                                       mask, reset, scale, save, seed,
                                       dropout_p, bits, psi_q)
    b, h, dh, t = q.shape
    f2 = w_r.shape[2]
    dt = (q.dtype,)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _build.check(name, x, (b, h, dh, t), _DTYPES)
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError("q, k and v must share one dtype")
    _build.check("rwbs", rwbs, (h, dh, 1), dt)
    _build.check("rrbs", rrbs, (h, dh, 1), dt)
    _build.check("w_r", w_r, (h, dh, f2), dt)
    _build.check("trig_a", trig_a, (t, f2), dt)
    _build.check("psi", psi, (f2, t), dt)
    if int8:
        _build.check("psi_q", psi_q, (f2, t), (torch.int8,))
    _build.check("mask", mask, (2, t, t), (torch.bfloat16,))
    _build.check("reset", reset, (b,), (torch.int32,))
    if not fwd_on_tensor_cores(dh, f2):
        _check_mem_fwd_widths(dh, f2)
        if int8 and f2 % 32:
            raise ValueError(f"2F={f2}: the int8 BD form takes 2F a "
                             "multiple of 32")
    out = torch.empty_like(q)
    res = (torch.empty((b, h, t, t), dtype=torch.float32, device=q.device),
           torch.empty((b, h, t), dtype=torch.float32, device=q.device)) \
        if save else (None, None)
    words = _words_along_depth(psi_q) if int8 else None
    drop = prng.kernel_args(seed, dropout_p, bits)
    _build.launch(
        _build.form("rel_attention_fwd", int8, drop[1], drop[3]), q.device,
        0 if q.dtype == torch.float32 else 1,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rwbs.data_ptr(),
        rrbs.data_ptr(), w_r.data_ptr(), trig_a.data_ptr(), psi.data_ptr(),
        words.data_ptr() if int8 else None,
        mask.data_ptr(), reset.data_ptr(), out.data_ptr(),
        *(x.data_ptr() if save else None for x in res), b, h, dh, t, f2,
        float(scale), *drop)
    return (out, *res) if save else out


def _trig_combine_bwd(dphi, trig_a):
    """Transpose of the per-query trig rotation in u (the reference's
    ``_trig_combine_bwd``): dphi [.., T, 2F] f32 -> du f32."""
    f = dphi.shape[-1] // 2
    d_cos, d_sin = dphi[..., :f], dphi[..., f:]
    s_a, c_a = trig_a[:, :f].float(), trig_a[:, f:].float()
    return torch.cat([d_cos * s_a - d_sin * c_a, d_cos * c_a + d_sin * s_a],
                     dim=-1)


def _attention_bwd_plain(q, rwbs, rrbs, k, v, w_r, trig_a, psi, s_res, lse,
                         out, dout, scale: float, seed: int, dropout_p: float,
                         bits=None, psi_q=None):
    """The backward both twins share, over keys k, v [B, H, dh, K] (f32 or
    the compute dtype): (dq in q's dtype; dk, dv [B, H, dh, K] f32, not yet
    rounded; dwr [H, dh, 2F], drwb, drrb [H, dh] f32).

    P = exp(S - lse) rounded to q's dtype (the reference's saved e);
    ds = P (dO^T v - rowsum(dO * O)), rounded; dv = dO P, dk = qw ds;
    du = rounded trig_combine_bwd(ds psi^T); dq = scale (k ds^T + W_r du^T);
    dW_r = sum_b qr du; d r_w_bias = scale * sum k ds^T, d r_r_bias =
    scale * W_r sum du.  With ``dropout_p`` > 0: probs = P under the masks
    of ``seed``, scaled; dv = dO rnd(probs) and ds = probs dP - P rowsum(dO
    * O), rounded (O was formed from the dropped probabilities, so the row
    term stands); the masks are drawn at width ``bits``.  With ``psi_q``
    (int8 [2F, K]) the dphi product alone takes the int8 form, from ds
    before its rounding (``quantize_ds_rows``)."""
    dt = q.dtype
    qw, qr = _query_streams(q, rwbs, rrbs, scale)
    k, v = k.float(), v.float()
    do = dout.float()
    p = torch.exp(s_res - lse[..., None]).to(dt).float()
    dp = torch.einsum("bhdi,bhdj->bhij", do, v)
    dr = (do * out.float()).sum(dim=2)
    if dropout_p > 0.0:
        keep, keep_scale = _attention_keep(seed, dropout_p, bits, *p.shape,
                                           p.device)
        probs = torch.where(keep, p * keep_scale, 0.0)
        ds_f = probs * dp - p * dr[..., None]
        p = probs.to(dt).float()
    else:
        ds_f = p * (dp - dr[..., None])
    ds = ds_f.to(dt).float()
    dv = torch.einsum("bhij,bhdi->bhdj", p, do)
    dk = torch.einsum("bhdi,bhij->bhdj", qw, ds)
    dq_ac = torch.einsum("bhij,bhdj->bhdi", ds, k)
    if psi_q is None:
        dphi = torch.einsum("bhij,fj->bhif", ds, psi.float())
    else:
        ds_q, sc = quantize_ds_rows(ds_f)
        dphi = _int_matmul(ds_q, psi_q.t()) * (sc * (1.0 / 127.0))
    du = _trig_combine_bwd(dphi, trig_a).to(dt).float()
    w = w_r.float()
    dq = (scale * (dq_ac + torch.einsum("hdf,bhif->bhdi", w, du))).to(dt)
    return (dq, dk, dv, torch.einsum("bhdi,bhif->hdf", qr, du),
            scale * dq_ac.sum(dim=(0, 3)),
            scale * torch.einsum("hdf,hf->hd", w, du.sum(dim=(0, 2))))


def rel_attention_bwd_plain(q, rwbs, rrbs, k, v, w_r, trig_a, psi, s_res,
                            lse, out, dout, scale: float, seed: int = 0,
                            dropout_p: float = 0.0,
                            bits: Optional[int] = None, psi_q=None):
    """Plain twin of the no-memory backward: the forward's operands, its
    residual (S [B, H, T, T], lse [B, H, T]) and output, and the cotangent
    dout [B, H, dh, T] -> (dq, dk, dv [B, H, dh, T] in q's dtype; dwr
    [H, dh, 2F], drwb, drrb [H, dh], f32).  See ``_attention_bwd_plain`` for
    the arithmetic and its roundings.  No dWk or dWv: every key is a window
    key, whose dk and dv reach the projection through autograd."""
    dq, dk, dv, dwr, drwb, drrb = _attention_bwd_plain(
        q, rwbs, rrbs, k, v, w_r, trig_a, psi, s_res, lse, out, dout, scale,
        seed, dropout_p, bits, psi_q)
    return dq, dk.to(q.dtype), dv.to(q.dtype), dwr, drwb, drrb


def _check_bwd_widths(dh: int, f2: int) -> None:
    """What the backward kernels take: head widths up to 128 and 2F a
    multiple of 256, every 2F that ``_fpad`` gives (ModelConfig()'s dh 50,
    2F 512 run the first form; wider heads or 2F past 512 the wide form,
    which takes 2F in chunks of 256)."""
    if dh > 128 or f2 < 256 or f2 % 256:
        raise ValueError(f"dh={dh}, 2F={f2}: the kernel takes dh <= 128 and "
                         "2F a multiple of 256")


def rel_attention_bwd(q, rwbs, rrbs, k, v, w_r, trig_a, psi, s_res, lse, out,
                      dout, scale: float, seed: int = 0,
                      dropout_p: float = 0.0, bits: Optional[int] = None,
                      psi_q=None):
    """The no-memory attention's backward on kernel operands (see the plain
    twin).  CPU tensors run ``rel_attention_bwd_plain``; CUDA tensors launch
    ``csrc/rel_attention_bwd.cu``."""
    args = (q, rwbs, rrbs, k, v, w_r, trig_a, psi, s_res, lse, out, dout)
    int8 = psi_q is not None
    if not _build.use_kernel(*args, *((psi_q,) if int8 else ())):
        return rel_attention_bwd_plain(*args, scale, seed, dropout_p, bits,
                                       psi_q)
    b, h, dh, t = q.shape
    f2 = w_r.shape[2]
    dt = (q.dtype,)
    _build.check("q", q, (b, h, dh, t), _DTYPES)
    for name, x in (("k", k), ("v", v), ("out", out), ("dout", dout)):
        _build.check(name, x, (b, h, dh, t), dt)
    _build.check("rwbs", rwbs, (h, dh, 1), dt)
    _build.check("rrbs", rrbs, (h, dh, 1), dt)
    _build.check("w_r", w_r, (h, dh, f2), dt)
    _build.check("trig_a", trig_a, (t, f2), dt)
    _build.check("psi", psi, (f2, t), dt)
    if int8:
        _build.check("psi_q", psi_q, (f2, t), (torch.int8,))
    _build.check("s_res", s_res, (b, h, t, t), (torch.float32,))
    _build.check("lse", lse, (b, h, t), (torch.float32,))
    _check_bwd_widths(dh, f2)
    dev = q.device
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    f32 = dict(dtype=torch.float32, device=dev)
    dwr = torch.empty((h, dh, f2), **f32)
    drwb = torch.empty((h, dh), **f32)
    drrb = torch.empty_like(drwb)
    work = _build.workspace("rel_attention_bwd", dev, b, h, dh, t, f2)
    psi_t = psi.t().contiguous()
    words = _words_along_keys(psi_q) if int8 else None
    drop = prng.kernel_args(seed, dropout_p, bits)
    _build.launch(
        _build.form("rel_attention_bwd", int8, drop[1], drop[3]), dev,
        0 if q.dtype == torch.float32 else 1,
        *(x.data_ptr() for x in (q, rwbs, rrbs, k, v, w_r, trig_a, psi_t,
                                 s_res, lse, out, dout, dq, dk, dv, dwr, drwb,
                                 drrb, work)),
        words.data_ptr() if int8 else None,
        b, h, dh, t, f2, float(scale), *drop)
    return dq, dk, dv, dwr, drwb, drrb


def _psi_q_operands(psi: torch.Tensor):
    """(the forward's psi_q, the backward's): ``quantize_psi_int8(psi)``
    where ``bd_int8()`` or ``bd_int8_bwd()`` asks for it, else None.  psi is
    the kernel operand: in the compute dtype, in ring order, after its
    dropout."""
    fwd, bwd = bd_int8(), bd_int8_bwd()
    psi_q = quantize_psi_int8(psi) if fwd or bwd else None
    return (psi_q if fwd else None, psi_q if bwd else None)


class _Attention(torch.autograd.Function):
    """fused_core's custom VJP: the bias fold happens inside, so the
    backward returns the bias gradients directly; the trig tables, mask and
    reset get none."""

    @staticmethod
    def forward(ctx, q, r_w_bias, r_r_bias, k_win, v_win, w_r, trig_a, psi,
                mask, reset, scale, seed, dropout_p, bits, psi_q_fwd,
                psi_q_bwd):
        rwbs, rrbs = _scaled_biases(r_w_bias, r_r_bias, scale, q.dtype)
        out, s_res, lse = rel_attention_fwd(
            q, rwbs, rrbs, k_win, v_win, w_r, trig_a, psi, mask, reset, scale,
            save=True, seed=seed, dropout_p=dropout_p, bits=bits,
            psi_q=psi_q_fwd)
        ctx.save_for_backward(q, rwbs, rrbs, k_win, v_win, w_r, trig_a, psi,
                              s_res, lse, out)
        ctx.scale, ctx.drop = scale, (seed, dropout_p, bits)
        ctx.psi_q = psi_q_bwd
        ctx.dtypes = (r_w_bias.dtype, r_r_bias.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        q, w_r = ctx.saved_tensors[0], ctx.saved_tensors[5]
        dq, dk, dv, dwr, drwb, drrb = rel_attention_bwd(
            *ctx.saved_tensors, g.to(q.dtype).contiguous(), ctx.scale,
            *ctx.drop, psi_q=ctx.psi_q)
        rwb_dt, rrb_dt = ctx.dtypes
        return (dq, drwb.to(rwb_dt), drrb.to(rrb_dt), dk, dv,
                dwr.to(w_r.dtype)) + (None,) * 10


def attention(q, k_win, v_win, w_r, psi, r_w_bias, r_r_bias,
              reset: Optional[torch.Tensor], *, d_model: int, scale: float,
              same_length: bool, dropout_p: float = 0.0,
              dropout_seed: int = 0, train: bool = False) -> torch.Tensor:
    """Kernel-layout entry point for the no-memory case (a fresh sequence).

    q, k_win, v_win: [B, H, dh, T]; w_r: [H, dh, 2F] (``pack_r_kernel``);
    psi: [2F, T] (``key_trig_basis``); r_w_bias, r_r_bias: [H, dh];
    reset: [B] bool or None; ``dropout_seed``: a Python int, read only when
    ``train`` and ``dropout_p`` > 0.  Returns [B, H, dh, T] in q's dtype.
    Differentiable in q, k_win, v_win, w_r and the biases when autograd
    asks for it (the backward is ``rel_attention_bwd``).  The draw width
    and the two int8 modes are read from the environment here
    (``prng.dropout_bits``, ``bd_int8``, ``bd_int8_bwd``); the backward runs
    with what the forward read."""
    drop = (int(dropout_seed),
            float(dropout_p) if train and dropout_p > 0.0 else 0.0,
            prng.dropout_bits())
    b, _, _, t = q.shape
    dt, dev = q.dtype, q.device
    trig_a = query_trig_table(t, 0, d_model, dtype=dt, device=dev)
    mask = build_mask_bias(t, 0, 0, 0, same_length, device=dev)
    if reset is None:
        reset = torch.zeros((b,), dtype=torch.int32, device=dev)
    args = (q.contiguous(), r_w_bias, r_r_bias, k_win.contiguous(),
            v_win.contiguous(), w_r.to(dt).contiguous())
    psi = psi.to(dt).contiguous()
    tables = (trig_a, psi, mask, reset.to(torch.int32), float(scale))
    psi_q = _psi_q_operands(psi)
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        return _Attention.apply(*args, *tables, *drop, *psi_q)
    q, r_w_bias, r_r_bias, k_win, v_win, w_r = args
    rwbs, rrbs = _scaled_biases(r_w_bias, r_r_bias, scale, dt)
    return rel_attention_fwd(q, rwbs, rrbs, k_win, v_win, w_r, *tables, False,
                             *drop, psi_q=psi_q[0])


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: 10
    mantissa bits kept, to nearest with ties away from zero, the low 13 bits
    zero (finite inputs)."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000
    out = (bits & ~0x7FFFFFFF) | mag
    return out.to(torch.int32).view(torch.float32).reshape(x.shape)


def tf32_split_product_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of f32 matrices in the 3xTF32 arithmetic of
    ``csrc/project_mem_kv.cu``: each operand split as hi = rna(x), lo =
    rna(x - hi), and a_lo b_hi + a_hi b_lo + a_hi b_hi summed in f32 (the
    products of TF32 values are exact in f32).  What the f32 kernel's
    numerics are held to on the CPU."""
    a_hi, b_hi = round_tf32(a), round_tf32(b)
    a_lo, b_lo = round_tf32(a.float() - a_hi), round_tf32(b.float() - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def project_mem_kv_plain(mem, layer_idx: int, wk, wv):
    """Plain twin of the memory K/V projection: mem [L+1, R, B, D, Tb] and
    wk, wv [D, H*dh] in mem's dtype -> k, v [B, R, H*dh, Tb] in mem's dtype,
    accumulated in f32."""
    x = mem[layer_idx].float()
    k = torch.einsum("do,rbdt->brot", wk.float(), x)
    v = torch.einsum("do,rbdt->brot", wv.float(), x)
    return k.to(mem.dtype), v.to(mem.dtype)


def project_mem_kv(mem, layer_idx: int, wk3, wv3):
    """Memory k/v projection of one layer of the blocked ring:
    mem [L+1, R, B, D, Tb] x wk3, wv3 [D, H, dh] -> (k, v) [B, R, H, dh, Tb]
    in mem's dtype.  The layer is indexed inside the buffer; no per-layer
    slice is copied.  CPU tensors run ``project_mem_kv_plain``; CUDA tensors
    launch ``csrc/project_mem_kv.cu``."""
    l1, r_blocks, b, d, t_blk = mem.shape
    heads, dh = wk3.shape[1], wk3.shape[2]
    if not 0 <= layer_idx < l1:
        raise ValueError(f"layer {layer_idx} outside the buffer's {l1}")
    wk = wk3.reshape(d, heads * dh).to(mem.dtype).contiguous()
    wv = wv3.reshape(d, heads * dh).to(mem.dtype).contiguous()
    shape = (b, r_blocks, heads, dh, t_blk)
    if not _build.use_kernel(mem, wk, wv):
        k, v = project_mem_kv_plain(mem, layer_idx, wk, wv)
        return k.reshape(shape), v.reshape(shape)
    _build.check("mem", mem, mem.shape, _DTYPES)
    code = 0 if mem.dtype == torch.float32 else 1
    k = torch.empty(shape, dtype=mem.dtype, device=mem.device)
    v = torch.empty_like(k)
    work = _build.workspace("project_mem_kv", mem.device, code, d, heads * dh)
    _build.launch(
        "project_mem_kv", mem.device, code, mem.data_ptr(), wk.data_ptr(),
        wv.data_ptr(), k.data_ptr(), v.data_ptr(), work.data_ptr(), layer_idx,
        r_blocks, b, d, t_blk, heads * dh)
    return k, v


def _ring_keys(x_mem, x_win):
    """[B, R, H, dh, Tb] ring slabs + [B, H, dh, T] window -> [B, H, dh, K]
    in key order (slot j of the ring is key j)."""
    b, r_blocks, h, dh, t_blk = x_mem.shape
    flat = x_mem.permute(0, 2, 3, 1, 4).reshape(b, h, dh, r_blocks * t_blk)
    return torch.cat([flat, x_win], dim=3)


def _check_mem_fwd_widths(dh: int, f2: int) -> None:
    """What the first design's body (``rel_attention_mem_fwd_body.cuh``,
    which the three forwards run at the widths their tensor-core body does
    not take: dh past 64, 2F past 512) takes: head widths up to 128 and a
    query side [phi | qw] that fits shared memory (2F = 1024 at dh = 128
    does, with 205 KB; so does every 2F up to 1280 at dh = 64)."""
    if dh > 128:
        raise ValueError(f"head width {dh}: the kernel takes at most 128")
    smem = 4 * (-(-(f2 + dh) // 32) * 32 * 32 + 2 * 32 * 64 + 32 * 65
                + 64 * dh + 128)
    if smem > 232448:
        raise ValueError(f"2F={f2}, dh={dh} need {smem} bytes of shared "
                         "memory per block; the kernel takes at most 227 KB")


def rel_attention_mem_fwd_plain(q, rwbs, rrbs, k_mem, k_win, v_mem, v_win,
                                w_r, trig_a, psi, mask, reset, scale: float,
                                save: bool = False, seed: int = 0,
                                dropout_p: float = 0.0,
                                bits: Optional[int] = None, psi_q=None):
    """Plain twin of the memory kernel: the no-memory twin over the keys
    [ring slabs | window], so it rounds P after normalising, as the
    reference does."""
    return rel_attention_fwd_plain(q, rwbs, rrbs, _ring_keys(k_mem, k_win),
                                   _ring_keys(v_mem, v_win), w_r, trig_a, psi,
                                   mask, reset, scale, save, seed, dropout_p,
                                   bits, psi_q)


def rel_attention_mem_fwd(q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r,
                          trig_a, psi, mask, reset, scale: float,
                          save: bool = False, seed: int = 0,
                          dropout_p: float = 0.0, bits: Optional[int] = None,
                          psi_q=None):
    """Attention over the XL memory and the window on kernel-layout
    operands.  q, k_win, v_win: [B, H, dh, T]; k_mem, v_mem:
    [B, R, H, dh, Tb] (``project_mem_kv``); rwbs, rrbs: [H, dh, 1]; w_r:
    [H, dh, 2F]; trig_a: [T, 2F]; psi: [2F, M+T] in ring order
    (``ring_psi``); mask: [2, T, M+T] bf16 in ring coordinates; reset: [B]
    int32.  Returns out [B, H, dh, T], or with ``save`` (out, S, lse): the
    backward's residual, f32 scores [B, H, T, M+T] (mask included) and row
    log-sum-exps [B, H, T].  ``bits``: the masks' draw width; ``psi_q``
    (int8 [2F, M+T], ``quantize_psi_int8`` of the ring-ordered psi) selects
    the int8 BD product.  CPU tensors run ``rel_attention_mem_fwd_plain``;
    CUDA tensors launch ``csrc/rel_attention_mem_fwd.cu``: its tensor-core
    body at dh <= 64 and 2F a multiple of 128 up to 512, and at every other
    width (dh up to 128; 2F up to 1024 at dh = 128, 1280 at dh = 64) its
    first design's FMA body, in both forms."""
    args = (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a, psi,
            mask, reset)
    int8 = psi_q is not None
    if not _build.use_kernel(*args, *((psi_q,) if int8 else ())):
        return rel_attention_mem_fwd_plain(*args, scale, save, seed,
                                           dropout_p, bits, psi_q)
    b, h, dh, t = q.shape
    r_blocks, t_blk = k_mem.shape[1], k_mem.shape[4]
    k_len = r_blocks * t_blk + t
    f2 = w_r.shape[2]
    dt = (q.dtype,)
    _build.check("q", q, (b, h, dh, t), _DTYPES)
    for name, x in (("k_win", k_win), ("v_win", v_win)):
        _build.check(name, x, (b, h, dh, t), dt)
    for name, x in (("k_mem", k_mem), ("v_mem", v_mem)):
        _build.check(name, x, (b, r_blocks, h, dh, t_blk), dt)
    _build.check("rwbs", rwbs, (h, dh, 1), dt)
    _build.check("rrbs", rrbs, (h, dh, 1), dt)
    _build.check("w_r", w_r, (h, dh, f2), dt)
    _build.check("trig_a", trig_a, (t, f2), dt)
    _build.check("psi", psi, (f2, k_len), dt)
    if int8:
        _build.check("psi_q", psi_q, (f2, k_len), (torch.int8,))
    _build.check("mask", mask, (2, t, k_len), (torch.bfloat16,))
    _build.check("reset", reset, (b,), (torch.int32,))
    _check_mem_fwd_widths(dh, f2)
    if int8 and f2 % 32:
        raise ValueError(f"2F={f2}: the int8 BD form takes 2F a multiple of "
                         "32")
    out = torch.empty_like(q)
    res = (torch.empty((b, h, t, k_len), dtype=torch.float32, device=q.device),
           torch.empty((b, h, t), dtype=torch.float32, device=q.device)) \
        if save else (None, None)
    words = _words_along_depth(psi_q) if int8 else None
    drop = prng.kernel_args(seed, dropout_p, bits)
    _build.launch(
        _build.form("rel_attention_mem_fwd", int8, drop[1], drop[3]),
        q.device, 0 if q.dtype == torch.float32 else 1,
        *(x.data_ptr() for x in args), out.data_ptr(),
        *(x.data_ptr() if save else None for x in res),
        words.data_ptr() if int8 else None, b, h, dh, t, r_blocks, t_blk, f2,
        float(scale), *drop)
    return (out, *res) if save else out


def proj_in_fwd() -> bool:
    """COMMU_PROJ_IN_FWD=1 (read at each call, as the reference does):
    ``attention_mem`` projects the memory's K/V inside the forward kernel
    (``rel_attention_proj_fwd``) instead of ``project_mem_kv`` followed by
    ``rel_attention_mem_fwd``; the backward reuses the slabs that forward
    wrote."""
    return os.environ.get("COMMU_PROJ_IN_FWD", "0") == "1"


def rel_attention_proj_fwd_plain(q, rwbs, rrbs, mem, layer_idx: int, wk, wv,
                                 k_win, v_win, w_r, trig_a, psi, mask, reset,
                                 scale: float, save: bool = False,
                                 seed: int = 0, dropout_p: float = 0.0,
                                 bits: Optional[int] = None):
    """Plain twin of the projecting forward: the projection twin, then the
    memory forward's twin over its slabs.  mem [L+1, R, B, D, Tb] and wk, wv
    [D, H*dh] in mem's dtype; the rest as ``rel_attention_mem_fwd``.
    Returns (out, k_mem, v_mem [B, R, H, dh, Tb]) and, with ``save``, S and
    lse after them."""
    b, h, dh, _ = q.shape
    r_blocks, t_blk = mem.shape[1], mem.shape[4]
    k_mem, v_mem = (x.reshape(b, r_blocks, h, dh, t_blk)
                    for x in project_mem_kv_plain(mem, layer_idx, wk, wv))
    res = rel_attention_mem_fwd_plain(
        q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a, psi, mask,
        reset, scale, save, seed, dropout_p, bits)
    return (res[0], k_mem, v_mem, *res[1:]) if save else (res, k_mem, v_mem)


def rel_attention_proj_fwd(q, rwbs, rrbs, mem, layer_idx: int, wk3, wv3,
                           k_win, v_win, w_r, trig_a, psi, mask, reset,
                           scale: float, save: bool = False, seed: int = 0,
                           dropout_p: float = 0.0,
                           bits: Optional[int] = None):
    """``project_mem_kv`` and ``rel_attention_mem_fwd`` in one kernel: the
    raw ring mem [L+1, R, B, D, Tb] read at ``layer_idx``, the projection
    slices wk3, wv3 [D, H, dh], and the memory forward's other operands ->
    (out [B, H, dh, T], k_mem, v_mem [B, R, H, dh, Tb] in mem's dtype) and,
    with ``save``, the residual S [B, H, T, M+T] and lse [B, H, T] after
    them.  It has no int8 BD form, as the
    reference's ``_fused_fwd_proj`` has none: under ``COMMU_BD_INT8=1`` it
    raises rather than run the exact product in silence.  CPU tensors run
    ``rel_attention_proj_fwd_plain``; CUDA tensors launch
    ``csrc/rel_attention_proj_fwd.cu``: at the widths of the memory
    forward's tensor-core body (``ModelConfig()``'s) its projection runs
    ``project_mem_kv``'s tile, so the slabs equal that kernel's, and the
    attention runs that body; at any other width its first design, f32 FMA
    loops whose slabs agree with ``project_mem_kv``'s to the f32
    tolerance."""
    if bd_int8():
        raise NotImplementedError(
            "COMMU_BD_INT8=1 has no form in the COMMU_PROJ_IN_FWD=1 forward "
            "(the quantised-psi operand exists only in rel_attention_fwd "
            "and rel_attention_mem_fwd); unset one of the two variables")
    l1, r_blocks, _, d_model, t_blk = mem.shape
    b, h, dh, t = q.shape
    if not 0 <= layer_idx < l1:
        raise ValueError(f"layer {layer_idx} outside the buffer's {l1}")
    if mem.dtype != q.dtype:
        raise TypeError(f"memory dtype {mem.dtype} must equal the "
                        f"activation dtype {q.dtype}")
    wk = wk3.reshape(d_model, h * dh).to(mem.dtype).contiguous()
    wv = wv3.reshape(d_model, h * dh).to(mem.dtype).contiguous()
    args = (q, rwbs, rrbs, mem, wk, wv, k_win, v_win, w_r, trig_a, psi, mask,
            reset)
    if not _build.use_kernel(*args):
        return rel_attention_proj_fwd_plain(
            q, rwbs, rrbs, mem, layer_idx, wk, wv, k_win, v_win, w_r, trig_a,
            psi, mask, reset, scale, save, seed, dropout_p, bits)
    k_len = r_blocks * t_blk + t
    f2 = w_r.shape[2]
    dt = (q.dtype,)
    _build.check("q", q, (b, h, dh, t), _DTYPES)
    for name, x in (("k_win", k_win), ("v_win", v_win)):
        _build.check(name, x, (b, h, dh, t), dt)
    _build.check("mem", mem, (l1, r_blocks, b, d_model, t_blk), dt)
    _build.check("rwbs", rwbs, (h, dh, 1), dt)
    _build.check("rrbs", rrbs, (h, dh, 1), dt)
    _build.check("w_r", w_r, (h, dh, f2), dt)
    _build.check("trig_a", trig_a, (t, f2), dt)
    _build.check("psi", psi, (f2, k_len), dt)
    _build.check("mask", mask, (2, t, k_len), (torch.bfloat16,))
    _build.check("reset", reset, (b,), (torch.int32,))
    _check_mem_fwd_widths(dh, f2)
    out = torch.empty_like(q)
    k_mem = torch.empty((b, r_blocks, h, dh, t_blk), dtype=mem.dtype,
                        device=mem.device)
    v_mem = torch.empty_like(k_mem)
    res = (torch.empty((b, h, t, k_len), dtype=torch.float32, device=q.device),
           torch.empty((b, h, t), dtype=torch.float32, device=q.device)) \
        if save else (None, None)
    code = 0 if q.dtype == torch.float32 else 1
    work = _build.workspace("rel_attention_proj_fwd", q.device, code,
                            d_model, h, dh, f2)
    drop = prng.kernel_args(seed, dropout_p, bits)
    _build.launch(
        _build.form("rel_attention_proj_fwd", False, drop[1], drop[3]),
        q.device, code, *(x.data_ptr() for x in args),
        out.data_ptr(), k_mem.data_ptr(), v_mem.data_ptr(),
        *(x.data_ptr() if save else None for x in res), work.data_ptr(),
        layer_idx, b, h, dh, t, r_blocks, t_blk, d_model, f2, float(scale),
        *drop)
    return (out, k_mem, v_mem, *res) if save else (out, k_mem, v_mem)


def rel_attention_mem_bwd_plain(q, rwbs, rrbs, k_mem, k_win, v_mem, v_win,
                                mem, layer_idx: int, w_r, trig_a, psi, s_res,
                                lse, out, dout, scale: float, seed: int = 0,
                                dropout_p: float = 0.0,
                                bits: Optional[int] = None, psi_q=None):
    """Plain twin of the memory backward: the forward's operands (mem is the
    ring [L+1, R, B, D, Tb] the keys were projected from, read at
    ``layer_idx``), its residual (S, lse) and output, and the cotangent dout
    [B, H, dh, T] -> (dq, dk_win, dv_win [B, H, dh, T] in q's dtype;
    dwk, dwv [H, dh, D], dwr [H, dh, 2F], drwb, drrb [H, dh], all f32).

    ``_attention_bwd_plain`` over the keys [ring slabs | window], and then
    dWk, dWv = sum_b rnd(dk, dv over the ring) mem^T."""
    dt = q.dtype
    r_blocks, t_blk = k_mem.shape[1], k_mem.shape[4]
    m_cap = r_blocks * t_blk
    dq, dk, dv, dwr, drwb, drrb = _attention_bwd_plain(
        q, rwbs, rrbs, _ring_keys(k_mem, k_win), _ring_keys(v_mem, v_win),
        w_r, trig_a, psi, s_res, lse, out, dout, scale, seed, dropout_p, bits,
        psi_q)
    b, d_model = mem.shape[2], mem.shape[3]
    ring = mem[layer_idx].permute(1, 2, 0, 3).reshape(b, d_model, m_cap)
    dwk, dwv = (torch.einsum("bhcj,bej->hce", x[..., :m_cap].to(dt).float(),
                             ring.float()) for x in (dk, dv))
    return (dq, dk[..., m_cap:].to(dt), dv[..., m_cap:].to(dt), dwk, dwv,
            dwr, drwb, drrb)


def rel_attention_mem_bwd(q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, mem,
                          layer_idx: int, w_r, trig_a, psi, s_res, lse, out,
                          dout, scale: float, seed: int = 0,
                          dropout_p: float = 0.0, bits: Optional[int] = None,
                          psi_q=None):
    """The memory attention's backward on kernel operands (see the plain
    twin); ``psi_q`` (int8 [2F, M+T]) selects the int8 dphi product.  CPU
    tensors run ``rel_attention_mem_bwd_plain``; CUDA tensors launch
    ``csrc/rel_attention_mem_bwd.cu``."""
    args = (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, mem, w_r, trig_a, psi,
            s_res, lse, out, dout)
    int8 = psi_q is not None
    if not _build.use_kernel(*args, *((psi_q,) if int8 else ())):
        return rel_attention_mem_bwd_plain(
            q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, mem, layer_idx, w_r,
            trig_a, psi, s_res, lse, out, dout, scale, seed, dropout_p, bits,
            psi_q)
    b, h, dh, t = q.shape
    l1, r_blocks, _, d_model, t_blk = mem.shape
    k_len = r_blocks * t_blk + t
    f2 = w_r.shape[2]
    dt = (q.dtype,)
    _build.check("q", q, (b, h, dh, t), _DTYPES)
    for name, x in (("k_win", k_win), ("v_win", v_win), ("out", out),
                    ("dout", dout)):
        _build.check(name, x, (b, h, dh, t), dt)
    for name, x in (("k_mem", k_mem), ("v_mem", v_mem)):
        _build.check(name, x, (b, r_blocks, h, dh, t_blk), dt)
    _build.check("mem", mem, (l1, r_blocks, b, d_model, t_blk), dt)
    _build.check("rwbs", rwbs, (h, dh, 1), dt)
    _build.check("rrbs", rrbs, (h, dh, 1), dt)
    _build.check("w_r", w_r, (h, dh, f2), dt)
    _build.check("trig_a", trig_a, (t, f2), dt)
    _build.check("psi", psi, (f2, k_len), dt)
    if int8:
        _build.check("psi_q", psi_q, (f2, k_len), (torch.int8,))
    _build.check("s_res", s_res, (b, h, t, k_len), (torch.float32,))
    _build.check("lse", lse, (b, h, t), (torch.float32,))
    if not 0 <= layer_idx < l1:
        raise ValueError(f"layer {layer_idx} outside the buffer's {l1}")
    _check_bwd_widths(dh, f2)
    dev = q.device
    dq, dkw, dvw = (torch.empty_like(q) for _ in range(3))
    f32 = dict(dtype=torch.float32, device=dev)
    dwk = torch.empty((h, dh, d_model), **f32)
    dwv = torch.empty_like(dwk)
    dwr = torch.empty((h, dh, f2), **f32)
    drwb = torch.empty((h, dh), **f32)
    drrb = torch.empty_like(drwb)
    work = _build.workspace("rel_attention_mem_bwd", dev, b, h, dh, t,
                            r_blocks, t_blk, d_model, f2)
    psi_t = psi.t().contiguous()
    words = _words_along_keys(psi_q) if int8 else None
    drop = prng.kernel_args(seed, dropout_p, bits)
    _build.launch(
        _build.form("rel_attention_mem_bwd", int8, drop[1], drop[3]), dev,
        0 if q.dtype == torch.float32 else 1,
        *(x.data_ptr() for x in (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win,
                                 mem, w_r, trig_a, psi_t, s_res, lse, out,
                                 dout, dq, dkw, dvw, dwk, dwv, dwr, drwb,
                                 drrb, work)),
        words.data_ptr() if int8 else None,
        layer_idx, b, h, dh, t, r_blocks, t_blk, d_model, f2, float(scale),
        *drop)
    return dq, dkw, dvw, dwk, dwv, dwr, drwb, drrb


class _AttentionMem(torch.autograd.Function):
    """fused_core_mem's custom VJP: the memory projection and the bias fold
    happen inside, so the backward returns the weight and bias gradients
    directly; the ring buffer, trig tables, mask and reset get none."""

    @staticmethod
    def forward(ctx, q, r_w_bias, r_r_bias, wk3, wv3, k_win, v_win, w_r, mem,
                layer_idx, trig_a, psi, mask, reset, scale, seed, dropout_p,
                bits, psi_q_fwd, psi_q_bwd):
        rwbs, rrbs = _scaled_biases(r_w_bias, r_r_bias, scale, q.dtype)
        if proj_in_fwd():
            out, k_mem, v_mem, s_res, lse = rel_attention_proj_fwd(
                q, rwbs, rrbs, mem, layer_idx, wk3, wv3, k_win, v_win, w_r,
                trig_a, psi, mask, reset, scale, save=True, seed=seed,
                dropout_p=dropout_p, bits=bits)
        else:
            k_mem, v_mem = project_mem_kv(mem, layer_idx, wk3, wv3)
            out, s_res, lse = rel_attention_mem_fwd(
                q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a, psi,
                mask, reset, scale, save=True, seed=seed,
                dropout_p=dropout_p, bits=bits, psi_q=psi_q_fwd)
        ctx.save_for_backward(q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, mem,
                              w_r, trig_a, psi, s_res, lse, out)
        ctx.layer_idx, ctx.scale = layer_idx, scale
        ctx.drop = (seed, dropout_p, bits)
        ctx.psi_q = psi_q_bwd
        ctx.dtypes = (r_w_bias.dtype, r_r_bias.dtype, wk3.dtype, wv3.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, mem, w_r, trig_a, psi,
         s_res, lse, out) = ctx.saved_tensors
        dq, dkw, dvw, dwk, dwv, dwr, drwb, drrb = rel_attention_mem_bwd(
            q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, mem, ctx.layer_idx, w_r,
            trig_a, psi, s_res, lse, out, g.to(q.dtype).contiguous(),
            ctx.scale, *ctx.drop, psi_q=ctx.psi_q)
        rwb_dt, rrb_dt, wk_dt, wv_dt = ctx.dtypes
        return (dq, drwb.to(rwb_dt), drrb.to(rrb_dt),
                dwk.permute(2, 0, 1).to(wk_dt), dwv.permute(2, 0, 1).to(wv_dt),
                dkw, dvw, dwr.to(w_r.dtype)) + (None,) * 12


def attention_mem(q, mem, layer_idx: int, wk3, wv3, k_win, v_win, w_r, psi,
                  r_w_bias, r_r_bias, mem_count: int, mem_head: int,
                  reset: Optional[torch.Tensor], *, d_model: int,
                  scale: float, same_length: bool, dropout_p: float = 0.0,
                  dropout_seed: int = 0, train: bool = False) -> torch.Tensor:
    """Like ``attention`` but over a nonempty XL memory: the raw blocked
    ring buffer mem [L+1, R, B, D, Tb] (in q's dtype) plus this layer's
    index and its k/v projection slices wk3, wv3 [D, H, dh].  psi: [2F, M+T]
    in ring order (``ring_psi``); ``mem_count`` and ``mem_head`` are the
    ring's host-side fill and write position; ``dropout_seed``: a Python
    int, read only when ``train`` and ``dropout_p`` > 0.  Returns
    [B, H, dh, T].
    Differentiable in q, the biases, wk3, wv3, k_win, v_win and w_r when
    autograd asks for it; the ring buffer is saved for the backward (which
    reads it for dWk/dWv), so it must not be rewritten before then.  The
    draw width and the two int8 modes are read from the environment here,
    as in ``attention``; ``COMMU_BD_INT8=1`` with ``COMMU_PROJ_IN_FWD=1``
    raises ``NotImplementedError``."""
    drop = (int(dropout_seed),
            float(dropout_p) if train and dropout_p > 0.0 else 0.0,
            prng.dropout_bits())
    if mem.dtype != q.dtype:
        raise TypeError(f"memory dtype {mem.dtype} must equal the "
                        f"activation dtype {q.dtype}")
    b, _, _, t = q.shape
    dt, dev = q.dtype, q.device
    m_cap = mem.shape[1] * mem.shape[4]
    trig_a = query_trig_table(t, m_cap, d_model, dtype=dt, device=dev)
    mask = build_mask_bias(t, m_cap, mem_count, mem_head, same_length,
                           device=dev)
    if reset is None:
        reset = torch.zeros((b,), dtype=torch.int32, device=dev)
    args = (q.contiguous(), r_w_bias, r_r_bias, wk3, wv3, k_win.contiguous(),
            v_win.contiguous(), w_r.to(dt).contiguous())
    psi = psi.to(dt).contiguous()
    psi_q = _psi_q_operands(psi)
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        return _AttentionMem.apply(*args, mem, layer_idx, trig_a, psi, mask,
                                   reset.to(torch.int32), float(scale), *drop,
                                   *psi_q)
    q, r_w_bias, r_r_bias, wk3, wv3, k_win, v_win, w_r = args
    rwbs, rrbs = _scaled_biases(r_w_bias, r_r_bias, scale, dt)
    tables = (w_r, trig_a, psi, mask, reset.to(torch.int32), float(scale),
              False, *drop)
    if proj_in_fwd():
        return rel_attention_proj_fwd(q, rwbs, rrbs, mem, layer_idx, wk3, wv3,
                                      k_win, v_win, *tables)[0]
    k_mem, v_mem = project_mem_kv(mem, layer_idx, wk3, wv3)
    return rel_attention_mem_fwd(q, rwbs, rrbs, k_mem, k_win, v_mem, v_win,
                                 *tables, psi_q=psi_q[0])
