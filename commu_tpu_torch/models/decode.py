"""Incremental decoding: prefill + per-row KV cache.

PyTorch counterpart of ``commu_tpu/models/decode.py``.  The cache is
left-aligned with a per-row ``length`` and keeps the reference's
[L, G, H, dh, M] layout.  ``decode_step`` computes one token for every row
in plain PyTorch (the reference computes it outside any Pallas kernel too),
with the XL position term factored through the angle-addition identity:
BD[g, h, m] = u[g, h] . emb(len_g - m) = phi(g, h) . psi(m).  ``commit``
appends through the ``cache_append`` kernel, IN PLACE: the returned cache
shares ``k`` and ``v`` with its argument.

``decode_step`` uses a two-pass LayerNorm (mean, then the mean of squared
deviations), while the full forward and the fused FFN kernel use the fast
variance; each matches its reference counterpart.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig

from ..ops.fused_attention import _fpad, _inv_freq, key_trig_basis, pack_r_kernel
from ..ops.layout import cache_append


@dataclass
class KVCache:
    """k, v: [L, G, H, dh, M]; length: [G] int32 valid prefix per row."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor

    def view(self, capacity: int) -> "KVCache":
        """The first ``capacity`` slots (a strided view, no copy)."""
        if capacity == self.k.shape[4]:
            return self
        return KVCache(self.k[..., :capacity], self.v[..., :capacity],
                       self.length)


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               dtype=torch.float32, device=None) -> KVCache:
    d_head = cfg.units // cfg.num_heads
    shape = (cfg.num_layers, batch, cfg.num_heads, d_head, capacity)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((batch,), dtype=torch.int32, device=device))


def precompute_rel(model, cfg: ModelConfig, max_distance: int):
    """(W_r [L, H, dh, 2F] packed per layer in the model dtype,
    psi [2F, max_distance+1] f32 per-slot trig basis).  The factoring needs
    the unclamped sinusoid: ``clamp_len > 0`` is refused."""
    if cfg.clamp_len > 0:
        raise NotImplementedError(
            "decode requires clamp_len <= 0 (reference default)")
    wr = torch.stack([pack_r_kernel(layer.dec_attn.r_net.weight.t(),
                                    cfg.num_heads)
                      for layer in model.layers])
    psi = key_trig_basis(max_distance + 1, cfg.units, dtype=torch.float32,
                         device=wr.device)
    return wr, psi


def _layer_norm(x, scale, bias, eps=1e-5):
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def decode_step(model, cfg: ModelConfig, rel, tokens: torch.Tensor,
                cache: KVCache) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token forward for every row.

    tokens: [G] — each row's last token; ``cache`` holds row g's context in
    its first ``length[g]`` slots (it may be a ``KVCache.view``).
    Returns (logits [G, V] f32, k_self [L, G, H, dh], v_self [L, G, H, dh]);
    the self K/V are not written: ``commit`` does that per row."""
    wr_all, psi = rel
    n_head = cfg.num_heads
    d_head = cfg.units // n_head
    hd = n_head * d_head
    capacity = cache.k.shape[4]
    scale = 1.0 / (d_head ** 0.5)
    fpad = _fpad(cfg.units)

    emb = model.embedding
    dtype = emb.dtype  # bf16 parameters -> mixed-precision decode
    x = emb[tokens] * torch.tensor(cfg.units ** 0.5, dtype=dtype)  # [G, D]
    r_w = model.r_w_bias.to(dtype)
    r_r = model.r_r_bias.to(dtype)

    j_idx = torch.arange(capacity, device=tokens.device)[None, :]
    valid = j_idx < cache.length[:, None]                            # [G, M]
    ang = cache.length[:, None].float() * _inv_freq(cfg.units,
                                                    tokens.device)[None, :]
    pad = fpad - ang.shape[1]
    sin_a = F.pad(torch.sin(ang), (0, pad))[:, None]                 # [G,1,F]
    cos_a = F.pad(torch.cos(ang), (0, pad))[:, None]
    psi_m = psi[:, :capacity]

    k_selfs, v_selfs = [], []
    for i, layer in enumerate(model.layers):
        attn = layer.dec_attn
        w_qkv = attn.qkv_net.weight
        q = F.linear(x, w_qkv[:hd]).reshape(-1, n_head, d_head)
        k_self = F.linear(x, w_qkv[hd:2 * hd]).reshape(-1, n_head, d_head)
        v_self = F.linear(x, w_qkv[2 * hd:]).reshape(-1, n_head, d_head)
        k_selfs.append(k_self)
        v_selfs.append(v_self)

        qw = (q + r_w).float()
        qr = (q + r_r).float()
        # scores accumulate in f32 over operands in the storage dtype
        ac = torch.einsum("ghd,ghdm->ghm", qw, cache.k[i].float())
        ac_self = (qw * k_self.float()).sum(dim=-1)
        u = torch.einsum("ghd,hdf->ghf", qr, wr_all[i].float())   # [G, H, 2F]
        u_s, u_c = u[..., :fpad], u[..., fpad:]
        phi = torch.cat([u_s * sin_a + u_c * cos_a,
                         u_c * sin_a - u_s * cos_a], dim=-1)
        bd = torch.einsum("ghf,fm->ghm", phi, psi_m)
        # the self term is distance 0: emb(0) = [sin 0 | cos 0] = [0.. | 1..]
        bd_self = u_c.sum(dim=-1)

        score = ((ac + bd) * scale).masked_fill(~valid[:, None, :],
                                                float("-inf"))
        score_self = ((ac_self + bd_self) * scale)[:, :, None]
        probs = torch.softmax(torch.cat([score, score_self], dim=2), dim=2)

        out = torch.einsum("ghm,ghdm->ghd",
                           probs[:, :, :capacity].to(dtype).float(),
                           cache.v[i].float())
        out = out + probs[:, :, capacity][:, :, None] * v_self.float()
        out = F.linear(out.to(dtype).reshape(-1, hd), attn.o_net.weight)

        ln = attn.layer_norm
        x = _layer_norm(x + out, ln.weight, ln.bias).to(dtype)
        ff = layer.pos_ff.CoreNet
        h = torch.relu(F.linear(x, ff[0].weight, ff[0].bias))
        h = F.linear(h, ff[3].weight, ff[3].bias)
        ln = layer.pos_ff.layer_norm
        x = _layer_norm(x + h, ln.weight, ln.bias).to(dtype)

    logits = model.logits(x)
    return logits, torch.stack(k_selfs), torch.stack(v_selfs)


def commit(cache: KVCache, k_self: torch.Tensor, v_self: torch.Tensor,
           advance: torch.Tensor) -> KVCache:
    """Append each row's self K/V at its current length where ``advance``
    (in place, through ``cache_append``); returns the cache with the new
    lengths.  ``cache`` must be the full cache, not a view."""
    k, v = cache_append(cache.k, cache.v, k_self, v_self, cache.length,
                        advance)
    return KVCache(k, v, cache.length + advance.to(torch.int32))


def prefill(model, cfg: ModelConfig, tokens: torch.Tensor,
            cache: KVCache) -> KVCache:
    """Full forward over the primer tokens [G, T] on the model's path
    (``TransformerXL.attn_impl``); every primer token's K/V enters the cache
    (written in place)."""
    batch, t = tokens.shape
    n_head = cfg.num_heads
    d_head = cfg.units // n_head
    hd = n_head * d_head
    # [G, D, T] per layer on the kernel path, [G, T, D] on the unfused one
    _, hids = model(tokens, return_hiddens=True)
    unfused = model.attn_impl == "xla"
    for i, layer in enumerate(model.layers):
        w_kv = layer.dec_attn.qkv_net.weight[hd:].float()
        h = hids[i].float()
        kv = torch.matmul(w_kv, h.transpose(1, 2) if unfused else h)
        cache.k[i, :, :, :, :t] = kv[:, :hd].reshape(batch, n_head, d_head, t)
        cache.v[i, :, :, :, :t] = kv[:, hd:].reshape(batch, n_head, d_head, t)
    length = torch.full((batch,), t, dtype=torch.int32, device=tokens.device)
    return KVCache(cache.k, cache.v, length)
