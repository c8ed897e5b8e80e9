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
  (``quantize_rows``), psi is ``psi_q`` again.  Only the copy of ds that
  enters this product is quantised: dk, dv and the content part of dq are
  those of the exact mode.

The reference's five opt-in levers of its attention kernels
(``fused_attention.py:458-582``), read at the same call (``levers``; the
backward runs with what its forward read): ``COMMU_SOFTMAX=clamp``,
``COMMU_DEFER_NORM=1`` and ``COMMU_SCALE_HOIST=1`` change the forwards'
softmax (``softmax_plain``), ``COMMU_INT8_DQ=1`` and ``COMMU_INT8_DK=1`` the
backwards' dq and dk (``quantize_rows``, ``quantize_cols``).  On the card
each runs a form of its kernel from the lever library
(``_build.lever_library``): the forwards' bodies already divide by the row
sum once, after P v, which is the deferred normalisation's order, so defer
and hoist share the form that moves the keep-scale there too (``Levers.soft``);
the backwards run their int8 dq and dk kernels after the passes
(``Levers.int8_grads``).  See ``Levers``.

The BD (query-position) term is computed through the angle-addition
factorization of the sinusoid, as in the reference: with u = qr^T W_r,

    BD[i, j] = u[i] . emb(M + i - j) = phi(i) . psi(j)

where phi rotates u by per-query trig factors (``query_trig_table``) and psi
is the per-key trig basis (``key_trig_basis``).  Layouts follow the
reference's kernel operands: q, k, v and the output are [B, H, dh, T].
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

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


class Levers(NamedTuple):
    """The reference's five opt-in numerics levers of its attention
    kernels (``fused_attention.py:458-582``), each read from the
    environment at each call (``levers``):

    - ``clamp`` (``COMMU_SOFTMAX=clamp``): e = exp(min(s, 60)) with no row
      maximum, the row sum guarded at 1e-30, so a row that underflows gives
      zeros and not NaN.  The residual saves min(S, 60) and lse = log(guarded
      sum), so the backward's P = exp(S - lse) is the clamped softmax.
    - ``defer`` (``COMMU_DEFER_NORM=1``): P v runs on the unnormalised,
      dropout-selected exps; 1 / sum x keep-scale scales the output columns
      after the product.
    - ``hoist`` (``COMMU_SCALE_HOIST=1``): under dropout the keep-scale
      scales the output columns after P v, not the probabilities (``defer``
      takes precedence, as in the reference).
    - ``int8_dq`` (``COMMU_INT8_DQ=1``): dq = [k | W_r] [ds | du]^T on int8
      operands, both quantised per output row (``quantize_rows``) from the
      unrounded ds and du.
    - ``int8_dk`` (``COMMU_INT8_DK=1``): dk = qw ds on int8 operands, qw
      quantised per head-dim row, ds per key column over the queries.

    The backward runs with the levers its forward read."""
    clamp: bool = False
    defer: bool = False
    hoist: bool = False
    int8_dq: bool = False
    int8_dk: bool = False

    @property
    def soft(self) -> int:
        """The forward kernels' form: bit 0 the clamped softmax, bit 1 the
        keep-scale after P v (``defer`` or ``hoist``; both bodies divide by
        the row sum after P v already).  0: the default form."""
        return int(self.clamp) | (2 if self.defer or self.hoist else 0)

    @property
    def int8_grads(self) -> int:
        """The backward kernels' form: bit 0 int8 dq, bit 1 int8 dk."""
        return int(self.int8_dq) | (2 if self.int8_dk else 0)


NO_LEVERS = Levers()


def levers() -> Levers:
    """The five levers as the environment sets them now."""
    env = os.environ.get
    return Levers(clamp=env("COMMU_SOFTMAX", "max") == "clamp",
                  defer=env("COMMU_DEFER_NORM", "0") == "1",
                  hoist=env("COMMU_SCALE_HOIST", "0") == "1",
                  int8_dq=env("COMMU_INT8_DQ", "0") == "1",
                  int8_dk=env("COMMU_INT8_DK", "0") == "1")


def quantize_rows(x: torch.Tensor):
    """The reference's ``_quant_rows`` (``fused_attention.py:479-483``) along
    the last dim: x f32 -> (x_q int8, sc [.., 1] f32) with sc = max(amax,
    1e-30) * f32(1 / 127) and x_q = round(x * (1 / sc)), half to even: a
    reciprocal, then a product (not the forward's 127 / amax).  The int8
    dphi quantises the unrounded ds [.., T, K] so, per query row (dphi =
    int32(ds_q psi_q^T) * (sc * (1 / 127))), and the int8 dq its operands."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    sc = torch.clamp(amax, min=1e-30) * (1.0 / 127.0)
    return torch.round(x * torch.reciprocal(sc)).to(torch.int8), sc


def quantize_cols(x: torch.Tensor):
    """The int8 dk's column quantiser (``_bwd_stage_b`` :965-967): x [.., T,
    K] f32 -> (x_q int8 [.., T, K], sc [.., 1, K]), each key column by its
    absolute maximum over the T rows, as ``quantize_rows`` does a row."""
    x_q, sc = quantize_rows(x.transpose(-1, -2))
    return x_q.transpose(-1, -2), sc.transpose(-1, -2)


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
                            bits: Optional[int] = None, psi_q=None,
                            levers: Levers = NO_LEVERS):
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
    unrounded until its own quantiser.  ``levers``: the forward's three
    (``clamp``, ``defer``, ``hoist``), as the reference's ``_attn_softmax``
    (:597-638) and ``_fwd_body`` (:657-667) compute them; under ``clamp``
    the residual S is min(S, 60)."""
    dt = q.dtype
    s = _scores_plain(q, rwbs, rrbs, k, w_r, trig_a, psi, mask, reset, scale,
                      psi_q)
    keep, keep_scale = (_attention_keep(seed, dropout_p, bits, *s.shape,
                                        s.device)
                        if dropout_p > 0.0 else (None, 1.0))
    p, col, s, lse = softmax_plain(s, keep, keep_scale, levers)
    out = torch.einsum("bhdj,bhij->bhdi", v.float(), p.to(dt).float())
    if col is not None:
        out = out * (col.transpose(-1, -2) if col.dim() else col)
    out = out.to(dt)
    if not save:
        return out
    return out, s, lse[..., 0]


def softmax_plain(s, keep=None, keep_scale=1.0, levers: Levers = NO_LEVERS):
    """The softmax phase of the reference's ``_attn_softmax`` (:585-638) and
    the column scale of ``_fwd_body`` (:660-667), on f32 scores s [.., T, K]
    and the dropout's keep mask (None: no dropout) and keep-scale ->
    (operand, col, s_res, lse): the P v operand before its rounding to the
    compute dtype; what scales the output columns after the product ([..,
    T, 1] under ``defer``, the keep-scale under ``hoist`` with dropout, else
    None); the residual S (min(s, 60) under ``clamp``); each row's
    log-sum-exp [.., T, 1]."""
    if levers.clamp:
        s = torch.clamp(s, max=60.0)
        e = torch.exp(s)
        # a row whose every score underflows exp gives zeros, not 1 / 0
        denom = torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
        lse = torch.log(denom)
    else:
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m)
        denom = e.sum(dim=-1, keepdim=True)
        lse = m + torch.log(denom)
    inv = 1.0 / denom
    if levers.defer:
        return (e if keep is None else torch.where(keep, e, 0.0),
                inv * keep_scale, s, lse)
    p = e * inv
    if keep is None:
        return p, None, s, lse
    if levers.hoist:
        return torch.where(keep, p, 0.0), keep_scale, s, lse
    return torch.where(keep, p * keep_scale, 0.0), None, s, lse


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
    """Whether ``rel_attention_fwd`` runs on the tensor cores at these
    widths, as the kernel library's launch decides: every width it takes
    does (heads up to 256, any even 2F), ``ModelConfig()``'s in the narrow
    body (``csrc/rel_attention_fwd_mma.cuh``), the others in the wide one
    (``csrc/rel_attention_fwd_wide.cuh``).  Both take any T."""
    return bool(_build.library().commu_rel_attention_fwd_on_tensor_cores(
        dh, f2))


def rel_attention_fwd(q, rwbs, rrbs, k, v, w_r, trig_a, psi, mask, reset,
                      scale: float, save: bool = False, seed: int = 0,
                      dropout_p: float = 0.0, bits: Optional[int] = None,
                      psi_q=None, levers: Levers = NO_LEVERS):
    """The attention core on kernel-layout operands (see the plain twin for
    shapes).  Returns out [B, H, dh, T], or with ``save`` (out, S, lse): the
    backward's residual, f32 scores [B, H, T, T] (mask included) and row
    log-sum-exps [B, H, T].  CPU tensors run ``rel_attention_fwd_plain``;
    CUDA tensors launch ``csrc/rel_attention_fwd.cu``: its tensor-core
    bodies, the narrow one at ``ModelConfig()``'s widths and the wide one
    at the others (dh up to 256; any T)."""
    int8 = psi_q is not None
    if not _build.use_kernel(q, k, v, w_r, trig_a, psi, mask, reset,
                             *((psi_q,) if int8 else ())):
        return rel_attention_fwd_plain(q, rwbs, rrbs, k, v, w_r, trig_a, psi,
                                       mask, reset, scale, save, seed,
                                       dropout_p, bits, psi_q, levers)
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
    _check_fwd_widths(dh, f2, int8)
    out = torch.empty_like(q)
    res = (torch.empty((b, h, t, t), dtype=torch.float32, device=q.device),
           torch.empty((b, h, t), dtype=torch.float32, device=q.device)) \
        if save else (None, None)
    words = _words_along_depth(psi_q) if int8 else None
    drop = prng.kernel_args(seed, dropout_p, bits)
    work = _fwd_workspace("rel_attention_fwd", q, int8, b, h, dh, t, f2)
    _build.launch(
        _lever_form("rel_attention_fwd", int8, drop, levers.soft), q.device,
        0 if q.dtype == torch.float32 else 1,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rwbs.data_ptr(),
        rrbs.data_ptr(), w_r.data_ptr(), trig_a.data_ptr(), psi.data_ptr(),
        words.data_ptr() if int8 else None,
        mask.data_ptr(), reset.data_ptr(), out.data_ptr(),
        *(x.data_ptr() if save else None for x in res), b, h, dh, t, f2,
        float(scale), *drop, None if work is None else work.data_ptr(),
        lever_build=levers.soft)
    return (out, *res) if save else out


# the launch counts' names of the lever forms (``Levers.soft``,
# ``Levers.int8_grads``): the forwards' form with the keep-scale after P v
# serves both COMMU_DEFER_NORM and COMMU_SCALE_HOIST
SOFT_TAGS = {1: "clamp", 2: "after", 3: "clamp+after"}
GRAD_TAGS = {1: "int8_dq", 2: "int8_dk", 3: "int8_dq+dk"}
# the lever build of the backward sources (both builds' entries take the
# form, ``Levers.int8_grads``: 0 in the default build)
BWD_LEVER_BUILD = 4


def _lever_form(kernel: str, int8: bool, drop, code: int,
                tags=SOFT_TAGS) -> str:
    """The name a launch is counted under: ``kernel[<lever>]`` for a lever
    form (whatever its BD product and masks), else ``_build.form``'s."""
    if code:
        return f"{kernel}[{tags[code]}]"
    return _build.form(kernel, int8, drop[1], drop[3])


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
                         bits=None, psi_q=None, levers: Levers = NO_LEVERS):
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
    before its rounding (``quantize_rows``).  ``levers``: the int8 dk
    and dq of the reference's ``_bwd_stage_b`` (:961-970, :995-1003), from
    the unrounded ds and du (the other three levers act in the forward)."""
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
    if levers.int8_dk:
        # the contraction runs over T: qw per head-dim row, ds per key
        # column, so the scales ride the output dims
        qw_q, sqw = quantize_rows(qw)
        ds_qc, scol = quantize_cols(ds_f)
        dk = _int_matmul(qw_q, ds_qc) * sqw * scol
    else:
        dk = torch.einsum("bhdi,bhij->bhdj", qw, ds)
    dq_ac = torch.einsum("bhij,bhdj->bhdi", ds, k)
    if psi_q is None:
        dphi = torch.einsum("bhij,fj->bhif", ds, psi.float())
    else:
        ds_q, sc = quantize_rows(ds_f)
        dphi = _int_matmul(ds_q, psi_q.t()) * (sc * (1.0 / 127.0))
    du_f = _trig_combine_bwd(dphi, trig_a)
    du = du_f.to(dt).float()
    w = w_r.float()
    if levers.int8_dq:
        # [k | W_r] per head-dim row and [ds | du] per query row, each over
        # the K + 2F columns of the one contraction
        kw_q, skw = quantize_rows(
            torch.cat([k, w.expand(k.shape[0], *w.shape)], dim=-1))
        dsu_q, sdsu = quantize_rows(torch.cat([ds_f, du_f], dim=-1))
        dq = (_int_matmul(kw_q, dsu_q.transpose(-1, -2)) * (skw * scale)
              * sdsu.transpose(-1, -2)).to(dt)
    else:
        dq = (scale * (dq_ac + torch.einsum("hdf,bhif->bhdi", w, du))).to(dt)
    return (dq, dk, dv, torch.einsum("bhdi,bhif->hdf", qr, du),
            scale * dq_ac.sum(dim=(0, 3)),
            scale * torch.einsum("hdf,hf->hd", w, du.sum(dim=(0, 2))))


def rel_attention_bwd_plain(q, rwbs, rrbs, k, v, w_r, trig_a, psi, s_res,
                            lse, out, dout, scale: float, seed: int = 0,
                            dropout_p: float = 0.0,
                            bits: Optional[int] = None, psi_q=None,
                            levers: Levers = NO_LEVERS):
    """Plain twin of the no-memory backward: the forward's operands, its
    residual (S [B, H, T, T], lse [B, H, T]) and output, and the cotangent
    dout [B, H, dh, T] -> (dq, dk, dv [B, H, dh, T] in q's dtype; dwr
    [H, dh, 2F], drwb, drrb [H, dh], f32).  See ``_attention_bwd_plain`` for
    the arithmetic and its roundings.  No dWk or dWv: every key is a window
    key, whose dk and dv reach the projection through autograd."""
    dq, dk, dv, dwr, drwb, drrb = _attention_bwd_plain(
        q, rwbs, rrbs, k, v, w_r, trig_a, psi, s_res, lse, out, dout, scale,
        seed, dropout_p, bits, psi_q, levers)
    return dq, dk.to(q.dtype), dv.to(q.dtype), dwr, drwb, drrb


def _check_bwd_widths(dh: int, f2: int) -> None:
    """What the backward kernels take: head widths up to 256 and 2F a
    multiple of 256, every 2F that ``_fpad`` gives (ModelConfig()'s dh 50,
    2F 512 run the first forms; wider heads or 2F past 512 the wide forms,
    csrc/rel_attention_bwd_wide.cuh)."""
    if dh > 256 or f2 < 256 or f2 % 256:
        raise ValueError(f"dh={dh}, 2F={f2}: the kernel takes dh <= 256 and "
                         "2F a multiple of 256")


def rel_attention_bwd(q, rwbs, rrbs, k, v, w_r, trig_a, psi, s_res, lse, out,
                      dout, scale: float, seed: int = 0,
                      dropout_p: float = 0.0, bits: Optional[int] = None,
                      psi_q=None, levers: Levers = NO_LEVERS):
    """The no-memory attention's backward on kernel operands (see the plain
    twin).  CPU tensors run ``rel_attention_bwd_plain``; CUDA tensors launch
    ``csrc/rel_attention_bwd.cu`` (its lever build under ``int8_dq`` or
    ``int8_dk``)."""
    args = (q, rwbs, rrbs, k, v, w_r, trig_a, psi, s_res, lse, out, dout)
    int8 = psi_q is not None
    if not _build.use_kernel(*args, *((psi_q,) if int8 else ())):
        return rel_attention_bwd_plain(*args, scale, seed, dropout_p, bits,
                                       psi_q, levers)
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
    grads = levers.int8_grads
    build = BWD_LEVER_BUILD if grads else 0
    work = _build.workspace("rel_attention_bwd", dev, b, h, dh, t, f2,
                            lever_build=build)
    psi_t = psi.t().contiguous()
    words = _words_along_keys(psi_q) if int8 else None
    drop = prng.kernel_args(seed, dropout_p, bits)
    _build.launch(
        _lever_form("rel_attention_bwd", int8, drop, grads, GRAD_TAGS), dev,
        0 if q.dtype == torch.float32 else 1,
        *(x.data_ptr() for x in (q, rwbs, rrbs, k, v, w_r, trig_a, psi_t,
                                 s_res, lse, out, dout, dq, dk, dv, dwr, drwb,
                                 drrb, work)),
        words.data_ptr() if int8 else None,
        b, h, dh, t, f2, float(scale), *drop, grads, lever_build=build)
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
                psi_q_bwd, levers):
        rwbs, rrbs = _scaled_biases(r_w_bias, r_r_bias, scale, q.dtype)
        out, s_res, lse = rel_attention_fwd(
            q, rwbs, rrbs, k_win, v_win, w_r, trig_a, psi, mask, reset, scale,
            save=True, seed=seed, dropout_p=dropout_p, bits=bits,
            psi_q=psi_q_fwd, levers=levers)
        ctx.save_for_backward(q, rwbs, rrbs, k_win, v_win, w_r, trig_a, psi,
                              s_res, lse, out)
        ctx.scale, ctx.drop = scale, (seed, dropout_p, bits)
        ctx.psi_q, ctx.levers = psi_q_bwd, levers
        ctx.dtypes = (r_w_bias.dtype, r_r_bias.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        q, w_r = ctx.saved_tensors[0], ctx.saved_tensors[5]
        dq, dk, dv, dwr, drwb, drrb = rel_attention_bwd(
            *ctx.saved_tensors, g.to(q.dtype).contiguous(), ctx.scale,
            *ctx.drop, psi_q=ctx.psi_q, levers=ctx.levers)
        rwb_dt, rrb_dt = ctx.dtypes
        return (dq, drwb.to(rwb_dt), drrb.to(rrb_dt), dk, dv,
                dwr.to(w_r.dtype)) + (None,) * 11


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
    asks for it (the backward is ``rel_attention_bwd``).  The draw width,
    the two int8 modes and the five levers are read from the environment
    here (``prng.dropout_bits``, ``bd_int8``, ``bd_int8_bwd``, ``levers``);
    the backward runs with what the forward read."""
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
    lv = levers()
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        return _Attention.apply(*args, *tables, *drop, *psi_q, lv)
    q, r_w_bias, r_r_bias, k_win, v_win, w_r = args
    rwbs, rrbs = _scaled_biases(r_w_bias, r_r_bias, scale, dt)
    return rel_attention_fwd(q, rwbs, rrbs, k_win, v_win, w_r, *tables, False,
                             *drop, psi_q=psi_q[0], levers=lv)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: 10
    mantissa bits kept, to nearest with ties away from zero, the low 13 bits
    zero (finite inputs)."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000
    out = (bits & ~0x7FFFFFFF) | mag
    return out.to(torch.int32).view(torch.float32).reshape(x.shape)


def truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` as the tensor cores read a TF32 operand: its low 13 bits
    dropped (truncation toward zero)."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32).reshape(x.shape)


def tf32_split_product_plain(a: torch.Tensor, b: torch.Tensor,
                             raw_lo: bool = False) -> torch.Tensor:
    """``a @ b`` of f32 matrices in the 3xTF32 arithmetic of the kernels'
    tensor-core products: each operand split as hi = rna(x), lo = rna(x -
    hi), and a_lo b_hi + a_hi b_lo + a_hi b_hi summed in f32 (the products
    of TF32 values are exact in f32).  ``raw_lo``: lo = x - hi left
    unrounded and read truncated, as the promoted sums of
    ``csrc/reduce.cuh`` and ``csrc/mma_tile.cuh`` take it
    (``split_tf32_raw_lo``).  What the f32 kernels' numerics are held to on
    the CPU."""
    lo = truncate_tf32 if raw_lo else round_tf32
    a_hi, b_hi = round_tf32(a), round_tf32(b)
    a_lo, b_lo = lo(a.float() - a_hi), lo(b.float() - b_hi)
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


def _check_fwd_widths(dh: int, f2: int, int8: bool) -> None:
    """What the two attention forwards take: head widths up to 256 and an
    even 2F (a multiple of 32 in the int8 BD form, whole words of psi_q)."""
    if dh > 256:
        raise ValueError(f"head width {dh}: the kernel takes at most 256")
    if f2 % 2 or (int8 and f2 % 32):
        raise ValueError(f"2F={f2}: the kernel takes an even 2F, and the "
                         "int8 BD form a multiple of 32")


def _fwd_workspace(kernel: str, q, int8: bool, b, h, dh, t, f2):
    """The query-side workspace of a forward's wide body where its streamed
    form runs (the query side past a block's shared memory), as the kernel
    library sizes it for this form; None where the launch needs none."""
    nbytes = getattr(_build.library(), f"commu_{kernel}_workspace")(
        0 if q.dtype == torch.float32 else 1, int(int8), b, h, dh, t, f2)
    return torch.empty((nbytes,), dtype=torch.uint8, device=q.device) \
        if nbytes else None


def rel_attention_mem_fwd_plain(q, rwbs, rrbs, k_mem, k_win, v_mem, v_win,
                                w_r, trig_a, psi, mask, reset, scale: float,
                                save: bool = False, seed: int = 0,
                                dropout_p: float = 0.0,
                                bits: Optional[int] = None, psi_q=None,
                                levers: Levers = NO_LEVERS):
    """Plain twin of the memory kernel: the no-memory twin over the keys
    [ring slabs | window], so it rounds P after normalising, as the
    reference does."""
    return rel_attention_fwd_plain(q, rwbs, rrbs, _ring_keys(k_mem, k_win),
                                   _ring_keys(v_mem, v_win), w_r, trig_a, psi,
                                   mask, reset, scale, save, seed, dropout_p,
                                   bits, psi_q, levers)


def rel_attention_mem_fwd(q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r,
                          trig_a, psi, mask, reset, scale: float,
                          save: bool = False, seed: int = 0,
                          dropout_p: float = 0.0, bits: Optional[int] = None,
                          psi_q=None, levers: Levers = NO_LEVERS):
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
    CUDA tensors launch ``csrc/rel_attention_mem_fwd.cu``: its narrow
    tensor-core body at dh <= 64 and 2F a multiple of 128 up to 512, and
    its wide one at every other width (dh up to 256, any even 2F), in both
    BD forms."""
    args = (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a, psi,
            mask, reset)
    int8 = psi_q is not None
    if not _build.use_kernel(*args, *((psi_q,) if int8 else ())):
        return rel_attention_mem_fwd_plain(*args, scale, save, seed,
                                           dropout_p, bits, psi_q, levers)
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
    _check_fwd_widths(dh, f2, int8)
    out = torch.empty_like(q)
    res = (torch.empty((b, h, t, k_len), dtype=torch.float32, device=q.device),
           torch.empty((b, h, t), dtype=torch.float32, device=q.device)) \
        if save else (None, None)
    words = _words_along_depth(psi_q) if int8 else None
    drop = prng.kernel_args(seed, dropout_p, bits)
    work = _fwd_workspace("rel_attention_mem_fwd", q, int8, b, h, dh, t, f2)
    _build.launch(
        _lever_form("rel_attention_mem_fwd", int8, drop, levers.soft),
        q.device, 0 if q.dtype == torch.float32 else 1,
        *(x.data_ptr() for x in args), out.data_ptr(),
        *(x.data_ptr() if save else None for x in res),
        words.data_ptr() if int8 else None, b, h, dh, t, r_blocks, t_blk, f2,
        float(scale), *drop, None if work is None else work.data_ptr(),
        lever_build=levers.soft)
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
                                 bits: Optional[int] = None,
                                 levers: Levers = NO_LEVERS):
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
        reset, scale, save, seed, dropout_p, bits, levers=levers)
    return (res[0], k_mem, v_mem, *res[1:]) if save else (res, k_mem, v_mem)


def rel_attention_proj_fwd(q, rwbs, rrbs, mem, layer_idx: int, wk3, wv3,
                           k_win, v_win, w_r, trig_a, psi, mask, reset,
                           scale: float, save: bool = False, seed: int = 0,
                           dropout_p: float = 0.0,
                           bits: Optional[int] = None,
                           levers: Levers = NO_LEVERS):
    """``project_mem_kv`` and ``rel_attention_mem_fwd`` in one kernel: the
    raw ring mem [L+1, R, B, D, Tb] read at ``layer_idx``, the projection
    slices wk3, wv3 [D, H, dh], and the memory forward's other operands ->
    (out [B, H, dh, T], k_mem, v_mem [B, R, H, dh, Tb] in mem's dtype) and,
    with ``save``, the residual S [B, H, T, M+T] and lse [B, H, T] after
    them.  It has no int8 BD form, as the
    reference's ``_fused_fwd_proj`` has none: under ``COMMU_BD_INT8=1`` it
    raises rather than run the exact product in silence.  CPU tensors run
    ``rel_attention_proj_fwd_plain``; CUDA tensors launch
    ``csrc/rel_attention_proj_fwd.cu``: its projection runs the mma.sync
    tile in ``project_mem_kv``'s depth steps and pass order (whose wgmma
    gives the same bits), so the slabs equal that kernel's bit for bit,
    and its attention runs the memory forward's body at these widths, the
    narrow one at ``ModelConfig()``'s and the wide one at every other, so
    out, S and lse equal ``rel_attention_mem_fwd``'s over those slabs."""
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
            psi, mask, reset, scale, save, seed, dropout_p, bits, levers)
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
    _check_fwd_widths(dh, f2, False)
    out = torch.empty_like(q)
    k_mem = torch.empty((b, r_blocks, h, dh, t_blk), dtype=mem.dtype,
                        device=mem.device)
    v_mem = torch.empty_like(k_mem)
    res = (torch.empty((b, h, t, k_len), dtype=torch.float32, device=q.device),
           torch.empty((b, h, t), dtype=torch.float32, device=q.device)) \
        if save else (None, None)
    code = 0 if q.dtype == torch.float32 else 1
    work = _build.workspace("rel_attention_proj_fwd", q.device, code, b,
                            d_model, h, dh, f2, lever_build=levers.soft)
    drop = prng.kernel_args(seed, dropout_p, bits)
    _build.launch(
        _lever_form("rel_attention_proj_fwd", False, drop, levers.soft),
        q.device, code, *(x.data_ptr() for x in args),
        out.data_ptr(), k_mem.data_ptr(), v_mem.data_ptr(),
        *(x.data_ptr() if save else None for x in res), work.data_ptr(),
        layer_idx, b, h, dh, t, r_blocks, t_blk, d_model, f2, float(scale),
        *drop, lever_build=levers.soft)
    return (out, k_mem, v_mem, *res) if save else (out, k_mem, v_mem)


def rel_attention_mem_bwd_plain(q, rwbs, rrbs, k_mem, k_win, v_mem, v_win,
                                mem, layer_idx: int, w_r, trig_a, psi, s_res,
                                lse, out, dout, scale: float, seed: int = 0,
                                dropout_p: float = 0.0,
                                bits: Optional[int] = None, psi_q=None,
                                levers: Levers = NO_LEVERS):
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
        psi_q, levers)
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
                          psi_q=None, levers: Levers = NO_LEVERS):
    """The memory attention's backward on kernel operands (see the plain
    twin); ``psi_q`` (int8 [2F, M+T]) selects the int8 dphi product.  CPU
    tensors run ``rel_attention_mem_bwd_plain``; CUDA tensors launch
    ``csrc/rel_attention_mem_bwd.cu`` (its lever build under ``int8_dq`` or
    ``int8_dk``)."""
    args = (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, mem, w_r, trig_a, psi,
            s_res, lse, out, dout)
    int8 = psi_q is not None
    if not _build.use_kernel(*args, *((psi_q,) if int8 else ())):
        return rel_attention_mem_bwd_plain(
            q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, mem, layer_idx, w_r,
            trig_a, psi, s_res, lse, out, dout, scale, seed, dropout_p, bits,
            psi_q, levers)
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
    grads = levers.int8_grads
    build = BWD_LEVER_BUILD if grads else 0
    work = _build.workspace("rel_attention_mem_bwd", dev, b, h, dh, t,
                            r_blocks, t_blk, d_model, f2, lever_build=build)
    psi_t = psi.t().contiguous()
    words = _words_along_keys(psi_q) if int8 else None
    drop = prng.kernel_args(seed, dropout_p, bits)
    _build.launch(
        _lever_form("rel_attention_mem_bwd", int8, drop, grads, GRAD_TAGS),
        dev, 0 if q.dtype == torch.float32 else 1,
        *(x.data_ptr() for x in (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win,
                                 mem, w_r, trig_a, psi_t, s_res, lse, out,
                                 dout, dq, dkw, dvw, dwk, dwv, dwr, drwb,
                                 drrb, work)),
        words.data_ptr() if int8 else None,
        layer_idx, b, h, dh, t, r_blocks, t_blk, d_model, f2, float(scale),
        *drop, grads, lever_build=build)
    return dq, dkw, dvw, dwk, dwv, dwr, drwb, drrb


class _AttentionMem(torch.autograd.Function):
    """fused_core_mem's custom VJP: the memory projection and the bias fold
    happen inside, so the backward returns the weight and bias gradients
    directly; the ring buffer, trig tables, mask and reset get none."""

    @staticmethod
    def forward(ctx, q, r_w_bias, r_r_bias, wk3, wv3, k_win, v_win, w_r, mem,
                layer_idx, trig_a, psi, mask, reset, scale, seed, dropout_p,
                bits, psi_q_fwd, psi_q_bwd, levers):
        rwbs, rrbs = _scaled_biases(r_w_bias, r_r_bias, scale, q.dtype)
        if proj_in_fwd():
            out, k_mem, v_mem, s_res, lse = rel_attention_proj_fwd(
                q, rwbs, rrbs, mem, layer_idx, wk3, wv3, k_win, v_win, w_r,
                trig_a, psi, mask, reset, scale, save=True, seed=seed,
                dropout_p=dropout_p, bits=bits, levers=levers)
        else:
            k_mem, v_mem = project_mem_kv(mem, layer_idx, wk3, wv3)
            out, s_res, lse = rel_attention_mem_fwd(
                q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a, psi,
                mask, reset, scale, save=True, seed=seed,
                dropout_p=dropout_p, bits=bits, psi_q=psi_q_fwd, levers=levers)
        ctx.save_for_backward(q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, mem,
                              w_r, trig_a, psi, s_res, lse, out)
        ctx.layer_idx, ctx.scale = layer_idx, scale
        ctx.drop = (seed, dropout_p, bits)
        ctx.psi_q, ctx.levers = psi_q_bwd, levers
        ctx.dtypes = (r_w_bias.dtype, r_r_bias.dtype, wk3.dtype, wv3.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, mem, w_r, trig_a, psi,
         s_res, lse, out) = ctx.saved_tensors
        dq, dkw, dvw, dwk, dwv, dwr, drwb, drrb = rel_attention_mem_bwd(
            q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, mem, ctx.layer_idx, w_r,
            trig_a, psi, s_res, lse, out, g.to(q.dtype).contiguous(),
            ctx.scale, *ctx.drop, psi_q=ctx.psi_q, levers=ctx.levers)
        rwb_dt, rrb_dt, wk_dt, wv_dt = ctx.dtypes
        return (dq, drwb.to(rwb_dt), drrb.to(rrb_dt),
                dwk.permute(2, 0, 1).to(wk_dt), dwv.permute(2, 0, 1).to(wv_dt),
                dkw, dvw, dwr.to(w_r.dtype)) + (None,) * 13


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
    draw width, the two int8 modes and the five levers are read from the
    environment here, as in ``attention``; ``COMMU_BD_INT8=1`` with
    ``COMMU_PROJ_IN_FWD=1`` raises ``NotImplementedError``."""
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
    lv = levers()
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        return _AttentionMem.apply(*args, mem, layer_idx, trig_a, psi, mask,
                                   reset.to(torch.int32), float(scale), *drop,
                                   *psi_q, lv)
    q, r_w_bias, r_r_bias, wk3, wv3, k_win, v_win, w_r = args
    rwbs, rrbs = _scaled_biases(r_w_bias, r_r_bias, scale, dt)
    tables = (w_r, trig_a, psi, mask, reset.to(torch.int32), float(scale),
              False, *drop)
    if proj_in_fwd():
        return rel_attention_proj_fwd(q, rwbs, rrbs, mem, layer_idx, wk3, wv3,
                                      k_win, v_win, *tables, levers=lv)[0]
    k_mem, v_mem = project_mem_kv(mem, layer_idx, wk3, wv3)
    return rel_attention_mem_fwd(q, rwbs, rrbs, k_mem, k_win, v_mem, v_win,
                                 *tables, psi_q=psi_q[0], levers=lv)
