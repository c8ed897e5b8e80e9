"""Transformer-XL language model, inference forward with no XL memory.

PyTorch counterpart of ``commu_tpu/models/transformer_xl.py`` on its kernel
("pallas") path: activations run feature-major [B, D, T] through the layer
stack, each layer is the relative-position attention kernel
(``ops.fused_attention.attention``) followed by the fused post-attention
block (``ops.fused_ffn.ffn_block``), and the embedding is tied to the
output projection.

Parameters carry the reference's state-dict names (torch ``Linear`` layout,
weight [out, in]), so a reference-format ``.pt`` loads with
``load_state_dict``:

    word_emb.emb_layers.0.weight  [V, D]  (tied: crit.out_layers.0.weight)
    crit.out_layers.0.bias        [V]
    r_w_bias / r_r_bias           [H, dh]
    layers.{i}.dec_attn.qkv_net.weight  [3*H*dh, D]  (rows: q | k | v)
    layers.{i}.dec_attn.r_net.weight    [H*dh, D]
    layers.{i}.dec_attn.o_net.weight    [D, H*dh]
    layers.{i}.dec_attn.layer_norm.{weight,bias}
    layers.{i}.pos_ff.CoreNet.{0,3}.{weight,bias}
    layers.{i}.pos_ff.layer_norm.{weight,bias}

The compute dtype is the parameters' dtype (``model.to(torch.bfloat16)``
gives the bf16 decode model).  Only the zero-capacity-memory forward (a
fresh sequence: prefill and parity checks) is ported; a nonempty XL memory
raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from commu_tpu.config import ModelConfig

from ..ops import fused_attention
from ..ops.fused_ffn import ffn_block


class Linear(nn.Module):
    """Weight [out, in] and optional bias; applied by the kernels, not here."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))


class Embedding(nn.Module):
    def __init__(self, num: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim))


class RelMultiHeadAttention(nn.Module):
    """Relative-position multi-head attention (reference ``dec_attn``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.units, cfg.units // cfg.num_heads * cfg.num_heads
        self.qkv_net = Linear(d, 3 * hd, bias=False)
        self.r_net = Linear(d, hd, bias=False)
        self.o_net = Linear(hd, d, bias=False)
        self.layer_norm = LayerNorm(d)

    def forward(self, x, psi, r_w_bias, r_r_bias, reset, same_length: bool):
        """x [B, D, T] -> o_net(attention) [B, D, T], before the residual
        and LayerNorm (which the fused FFN block applies)."""
        cfg = self.cfg
        b, d, t = x.shape
        h = cfg.num_heads
        dh = d // h
        hd = h * dh
        qkv = torch.matmul(self.qkv_net.weight, x)         # [B, 3*hd, T]
        q, k, v = (qkv[:, i * hd:(i + 1) * hd].reshape(b, h, dh, t)
                   for i in range(3))
        w_r = fused_attention.pack_r_kernel(self.r_net.weight.t(), h)
        vec = fused_attention.attention(
            q, k, v, w_r, psi, r_w_bias, r_r_bias, reset, d_model=d,
            scale=1.0 / dh ** 0.5, same_length=same_length)
        return torch.matmul(self.o_net.weight, vec.reshape(b, hd, t))


class PositionwiseFF(nn.Module):
    """Reference ``pos_ff``; CoreNet keeps the reference's module indices
    (Linear, ReLU, Dropout, Linear) so the weights sit at CoreNet.0 / .3."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.CoreNet = nn.ModuleList([
            Linear(cfg.units, cfg.inner_size), nn.ReLU(), nn.Identity(),
            Linear(cfg.inner_size, cfg.units)])
        self.layer_norm = LayerNorm(cfg.units)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.dec_attn = RelMultiHeadAttention(cfg)
        self.pos_ff = PositionwiseFF(cfg)

    def forward(self, x, psi, r_w_bias, r_r_bias, reset, same_length: bool):
        o = self.dec_attn(x, psi, r_w_bias, r_r_bias, reset, same_length)
        ln1, ff, ln2 = self.dec_attn.layer_norm, self.pos_ff.CoreNet, \
            self.pos_ff.layer_norm
        return ffn_block(x, o, ff[0].weight.t(), ff[0].bias, ff[3].weight.t(),
                         ff[3].bias, ln1.weight, ln1.bias, ln2.weight,
                         ln2.bias)


class _WordEmbedding(nn.Module):
    def __init__(self, vocab_size: int, d_model: int):
        super().__init__()
        self.emb_layers = nn.ModuleList([Embedding(vocab_size, d_model)])


class _Crit(nn.Module):
    def __init__(self, vocab_size: int, d_model: int):
        super().__init__()
        self.out_layers = nn.ModuleList([Linear(d_model, vocab_size)])


class TransformerXL(nn.Module):
    """The LM.  ``forward`` -> hidden [B, T, D]; ``logits`` projects hidden
    states through the tied embedding.  Parameters are uninitialized until
    ``init_parameters`` or ``load_state_dict``."""

    def __init__(self, vocab_size: int, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        if cfg.clamp_len > 0:
            raise NotImplementedError(
                "clamp_len > 0 does not factor through the kernel's "
                "angle-addition BD term")
        self.cfg = cfg
        d_head = cfg.units // cfg.num_heads
        self.word_emb = _WordEmbedding(vocab_size, cfg.units)
        self.crit = _Crit(vocab_size, cfg.units)
        self.crit.out_layers[0].weight = self.word_emb.emb_layers[0].weight
        self.r_w_bias = nn.Parameter(torch.empty(cfg.num_heads, d_head))
        self.r_r_bias = nn.Parameter(torch.empty(cfg.num_heads, d_head))
        self.layers = nn.ModuleList(
            [DecoderLayer(cfg) for _ in range(cfg.num_layers)])

    @property
    def embedding(self) -> torch.Tensor:
        return self.word_emb.emb_layers[0].weight

    @property
    def out_bias(self) -> torch.Tensor:
        return self.crit.out_layers[0].bias

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initializer: normal(0.01) weights and embedding,
        LayerNorm scales 1 + N(0, 0.01), zero biases.  Draws on the CPU from
        ``generator`` in parameter order, so a seed gives the same weights
        on every device."""
        for name, p in self.named_parameters():
            noise = torch.randn(p.shape, generator=generator) * 0.01
            if name.endswith("layer_norm.weight"):
                value = 1.0 + noise
            elif name.endswith(".bias"):
                value = torch.zeros(p.shape)
            else:
                value = noise
            p.copy_(value)

    def forward(self, tokens: torch.Tensor,
                reset: Optional[torch.Tensor] = None, *,
                memory: Optional[torch.Tensor] = None,
                same_length: bool = False, return_hiddens: bool = False):
        """tokens [B, T] -> hidden [B, T, D] (and, with ``return_hiddens``,
        the per-layer hiddens: L+1 tensors [B, D, T], the input of every
        layer followed by the last layer's output).

        ``memory`` [L+1, B, M, D] must be absent or empty: a nonempty XL
        memory (the reference's ``attention_mem`` path) is not ported."""
        if memory is not None and memory.shape[2] > 0:
            raise NotImplementedError(
                "forward over a nonempty XL memory is not ported")
        cfg = self.cfg
        emb = self.embedding
        dtype = emb.dtype
        t = tokens.shape[1]
        x = (emb[tokens] * torch.tensor(cfg.units ** 0.5, dtype=dtype))
        x = x.transpose(1, 2).contiguous()                   # [B, D, T]
        psi = fused_attention.key_trig_basis(t, cfg.units, dtype,
                                             device=tokens.device)
        hids = [x]
        for layer in self.layers:
            x = layer(x, psi, self.r_w_bias, self.r_r_bias, reset,
                      same_length)
            hids.append(x)
        out = x.transpose(1, 2)
        return (out, hids) if return_hiddens else out

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Tied-embedding output projection, in f32."""
        return hidden.float() @ self.embedding.float().t() + \
            self.out_bias.float()
