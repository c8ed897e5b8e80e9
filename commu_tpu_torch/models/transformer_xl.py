"""Transformer-XL language model: the forward with or without XL memory, and
the training forward over the memory.

PyTorch counterpart of ``commu_tpu/models/transformer_xl.py``, on both of
its paths (``resolve_attn_impl``).  On the kernel ("pallas") path
activations run feature-major [B, D, T] through the layer
stack, each layer is the relative-position attention kernel
(``ops.fused_attention.attention``, or ``attention_mem`` over a nonempty XL
memory) followed by the fused post-attention block
(``ops.fused_ffn.ffn_block``), and the embedding is tied to the output
projection.

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

The compute dtype is ``TransformerXL(dtype=...)``, as in the JAX package:
parameters may stay f32 and are cast where the reference casts them (the
projection weights; the embedding after its f32 scaling; biases and
LayerNorm parameters are read in f32).  With ``dtype=None`` it is the
parameters' dtype, so ``model.to(torch.bfloat16)`` gives the bf16 decode
model.

The XL memory is the reference's blocked D-major ring ``Memory``
([L+1, R, B, D, Tb], slot j at slab j // Tb, lane j % Tb), with its fill
``count`` and write position ``head`` kept as host integers: the eval loop's
memory advance does not depend on the data, so masks and the ring-ordered
key basis are built without a device sync.  ``forward`` writes the new rows
into the ring IN PLACE (``ops.layout.ring_write_layer``), where the
reference returns a new buffer.  ``forward_train`` writes nothing: the
attention backward reads the ring (for dWk/dWv), so the train step writes
the detached rows with ``advance_memory`` after ``backward()``, as the
reference's step does.

Every op of the stack is differentiable through a hand-written backward:
the embedding (``ops.embed.embed_bdt``), the attention over the window
alone (``fused_attention.attention``: a memory of capacity 0, or none) and
over memory (``attention_mem``), the FFN block (``ffn_block``), the
activation dropout (``ops.dropout.dropout_bdt``); the window q/k/v/o and r
projections are ``torch.matmul``.  Two environment variables switch the
reference's fused probes on, read at every forward: ``COMMU_PROJ_IN_FWD=1``
projects the memory's K/V inside the attention forward kernel, and
``COMMU_O_IN_FFN=1`` moves the o projection into the FFN kernels
(``ffn_block_fused_o``).

Dropout (a forward given a ``DropoutDraw``) has the reference's six kinds of
site: the positional dropout on the ring-ordered key basis psi (plain torch,
from a mask the caller drew: flax's ``nn.Dropout`` outside any kernel), the
embedding and output sites (``dropout_bdt``), and in every layer the
attention mask and the FFN block's three masks, each drawn inside its kernel
from one int32 seed.  Without a draw the forward is deterministic.

The unfused ("xla") path, which ``attn_impl="xla"`` or ``clamp_len > 0``
selects, is the reference's XLA path in plain torch and launches none of
the kernels: activations [B, T, D], the q/kv/r projections over the
[memory; window] concat, ``ac + rel_shift(bd)`` over the sinusoid of
``ops.rel_attention`` (clamped at ``clamp_len``), the mask, softmax,
``P v``, ``o_net``, then residual, LayerNorm and the position-wise FFN as
separate ops; its memory is the dense right-aligned shift buffer
([L+1, B, M, D], ``init_memory(dense=True)``), and its dropout a plain
Bernoulli drop from one ``torch.Generator`` on the activations' device.

Three more variables select the reference's fast numerics, read by the ops
at each call: ``COMMU_DROPOUT_BITS`` (8 or 16 random bits a decision of the
in-kernel masks; the psi mask stays at 16), ``COMMU_BD_INT8=1`` (the
attention forward's BD product on int8 operands, with or without a draw) and
``COMMU_BD_INT8_BWD=1`` (the backward's dphi product).  Unset, the model
computes exact products and draws at 16 bits; ``commu_tpu_torch.train`` sets
them unless ``--precise_bd`` is given.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig

from ..ops import fused_attention, prng
from ..ops.dropout import SALT_EMB, SALT_OUT, dropout_bdt
from ..ops.embed import embed_bdt
from ..ops.fused_ffn import ffn_block, ffn_block_fused_o, o_in_ffn
from ..ops.layout import ring_write_layer
from ..ops.rel_attention import (build_attention_mask, rel_shift,
                                 relative_position_embedding)


def resolve_attn_impl(cfg: ModelConfig) -> str:
    """"pallas" (the kernel path: the hand-written kernels on a CUDA device,
    their plain versions on the CPU) for ``attn_impl`` "auto" or "pallas";
    "xla" (the unfused path) for "xla", and for any ``clamp_len > 0``: the
    kernels compute the position term through the angle-addition identity,
    which holds for the unclamped sinusoid only."""
    impl = cfg.attn_impl
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"attn_impl {impl!r}: expected auto, pallas or xla")
    if impl == "xla" or cfg.clamp_len > 0:
        return "xla"
    return "pallas"


@dataclass
class Memory:
    """XL memory, one stream per layer input plus the last layer's output,
    with ``count`` valid slots (clamped at the capacity M) and the next
    write position ``head``.  Two layouts: the kernel path's blocked ring
    hidden [L+1, R, B, D, Tb] (M = R*Tb), and with ``dense`` the unfused
    path's right-aligned shift buffer [L+1, B, M, D] (the newest token at
    the right edge, ``head`` 0)."""

    hidden: torch.Tensor
    count: int = 0
    head: int = 0
    dense: bool = False


@dataclass
class DropoutDraw:
    """The random numbers of one training forward: an int32 seed (a Python
    int in [0, 2^31 - 1)) for the embedding site, the output site, and each
    layer's attention and FFN block, and the keep mask of the positional
    dropout, bool [2F, M + T] (any device)."""

    emb_seed: int
    out_seed: int
    attn_seeds: Sequence[int]
    ffn_seeds: Sequence[int]
    psi_keep: torch.Tensor


def draw_dropout(generator: torch.Generator, cfg: ModelConfig, k_len: int,
                 device=None) -> DropoutDraw:
    """Draw one forward's seeds from ``generator`` (a CPU generator: the draw
    waits on no device), in the order the reference draws: psi, embedding,
    each layer's attention then FFN, output.  The positional mask is the
    hash mask of its seed (``ops.prng.keep_mask``), made on ``device``: the
    same bits on every device, and no host pass over its 2F x K elements.
    That mask drops at t16 / 65536 (0.100006 at p = 0.1), while the forward
    scales the kept psi by flax's 1 / (1 - p), not by ``keep_scale_for``: a
    Bernoulli mask handed over from the reference pairs exactly with that
    scale, and this one's expectation is off by about 6e-6 relative.  It is
    drawn at 16 bits whatever ``COMMU_DROPOUT_BITS`` says: in the reference
    this mask is ``nn.Dropout``'s own Bernoulli draw, which does not follow
    the kernels' draw width, and at 8 bits its rate (26 / 256) would no
    longer pair with 1 / (1 - p).
    ``k_len``: memory capacity plus window length."""
    seeds = torch.randint(0, 2 ** 31 - 1, (2 * cfg.num_layers + 3,),
                          generator=generator).tolist()
    psi_keep = prng.keep_mask(
        seeds[0], (2 * fused_attention._fpad(cfg.units), k_len), cfg.dropout,
        device=device, bits=16)
    seeds = seeds[1:]
    return DropoutDraw(seeds[0], seeds[-1], seeds[1:-1:2], seeds[2:-1:2],
                       psi_keep)


def dropout_generator(generator: torch.Generator, device) -> torch.Generator:
    """The unfused path's draw for one training step: a generator on
    ``device`` seeded from ``generator`` (a CPU generator: the draw waits on
    no device); every dropout site of the step draws from it in turn."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)


def plain_dropout(x: torch.Tensor, p: float,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``nn.Dropout`` in plain torch: keep each element with
    probability 1 - p (a Bernoulli draw from ``generator``), scaled by
    1 / (1 - p); ``x`` itself without a generator or at p = 0."""
    if generator is None or p <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return x.masked_fill(~keep, 0.0) / (1.0 - p)


def _layer_norm(x: torch.Tensor, ln: "LayerNorm") -> torch.Tensor:
    """The reference's LayerNorm over the last axis of an f32 ``x``: the
    fast variance E[x^2] - E[x]^2 (clamped at 0), eps 1e-5, f32 scale and
    bias."""
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    return (x - mean) * torch.rsqrt(var + 1e-5) * ln.weight.float() + \
        ln.bias.float()


def ring_blocks(capacity: int, block_len: Optional[int]) -> Tuple[int, int]:
    """(R, Tb) slab decomposition of a blocked ring: R slabs of Tb token
    slots (Tb = ``block_len`` or the whole capacity); Tb must divide the
    capacity."""
    t = block_len or capacity
    r = capacity // t if t else 0
    if r * (t or 0) != capacity:
        raise ValueError(f"block length {t} does not divide capacity {capacity}")
    return r, t


def init_memory(num_layers: int, batch: int, capacity: int, d_model: int,
                dtype=torch.float32, block_len: Optional[int] = None,
                device=None, dense: bool = False) -> Memory:
    """An empty memory: a ring, or with ``dense`` the unfused path's shift
    buffer.  A ring's ``block_len`` must equal the window length the memory
    is updated with (eval ``tgt_length``).  The buffer is zeros, never
    uninitialized: a masked slot still multiplies its value, and NaN there
    would poison the row."""
    if dense:
        return Memory(torch.zeros((num_layers + 1, batch, capacity, d_model),
                                  dtype=dtype, device=device), dense=True)
    r, t = ring_blocks(capacity, block_len)
    return Memory(torch.zeros((num_layers + 1, r, batch, d_model, t),
                              dtype=dtype, device=device))


def memory_capacity(memory: Memory) -> int:
    if memory.dense:
        return memory.hidden.shape[-2]
    return memory.hidden.shape[1] * memory.hidden.shape[4]


def shift_memory(hidden: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The dense buffer ``hidden`` [..., M, D] advanced by ``rows``
    [..., T, D]: the oldest T slots drop out on the left, the rows enter on
    the right (a new tensor)."""
    m_cap, t = hidden.shape[-2], rows.shape[-2]
    rows = rows.detach().to(hidden.dtype)
    if m_cap == 0:
        return hidden
    if t >= m_cap:
        return rows[..., t - m_cap:, :].contiguous()
    return torch.cat([hidden[..., t:, :], rows], dim=-2)


def logical_memory_view(memory: Memory) -> torch.Tensor:
    """Memory contents as [L+1, B, M, D] in the right-aligned layout (ring
    start = (head - count) mod M maps logical l -> physical (start + l) mod
    M; the newest token lands at the right edge).  A dense memory is that
    layout already."""
    if memory.dense:
        return memory.hidden
    l1, r, b, d, t = memory.hidden.shape
    hidden = memory.hidden.permute(0, 2, 3, 1, 4).reshape(l1, b, d, r * t)
    hidden = hidden.transpose(2, 3)
    m_cap = r * t
    if m_cap == 0:
        return hidden
    start = (memory.head - memory.count) % m_cap
    rolled = torch.roll(hidden, -start, dims=2)
    return torch.roll(rolled, m_cap - memory.count, dims=2)


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

    def forward(self, x, psi, r_w_bias, r_r_bias, reset, same_length: bool,
                memory: Optional[Memory] = None, layer_idx: int = 0,
                dropout_seed: Optional[int] = None, project: bool = True):
        """x [B, D, T] in the compute dtype -> o_net(attention) [B, D, T],
        before its dropout, the residual and LayerNorm (which the fused FFN
        block applies).  With a nonempty ``memory`` the keys are [ring |
        window] and this layer reads ring stream ``layer_idx``.  With a
        ``dropout_seed`` the probabilities drop at ``attention_dropout``.
        ``project=False`` returns the attention vector [B, H*dh, T] before
        ``o_net`` (for ``ffn_block_fused_o``)."""
        cfg = self.cfg
        b, d, t = x.shape
        h = cfg.num_heads
        dh = d // h
        hd = h * dh
        scale = 1.0 / dh ** 0.5
        drop = dict(dropout_p=cfg.attention_dropout,
                    dropout_seed=dropout_seed or 0,
                    train=dropout_seed is not None)
        w_qkv = self.qkv_net.weight.to(x.dtype)
        qkv = torch.matmul(w_qkv, x)                       # [B, 3*hd, T]
        q, k, v = (qkv[:, i * hd:(i + 1) * hd].reshape(b, h, dh, t)
                   for i in range(3))
        w_r = fused_attention.pack_r_kernel(self.r_net.weight.t().to(x.dtype),
                                            h)
        if memory is not None and memory_capacity(memory) > 0:
            wk3 = w_qkv[hd:2 * hd].t().reshape(d, h, dh)
            wv3 = w_qkv[2 * hd:].t().reshape(d, h, dh)
            vec = fused_attention.attention_mem(
                q, memory.hidden, layer_idx, wk3, wv3, k, v, w_r, psi,
                r_w_bias, r_r_bias, memory.count, memory.head, reset,
                d_model=d, scale=scale, same_length=same_length, **drop)
        else:
            vec = fused_attention.attention(
                q, k, v, w_r, psi, r_w_bias, r_r_bias, reset, d_model=d,
                scale=scale, same_length=same_length, **drop)
        vec = vec.reshape(b, hd, t)
        if not project:
            return vec
        return torch.matmul(self.o_net.weight.to(x.dtype), vec)

    def forward_unfused(self, x, mem, pos_emb, mask, r_w_bias, r_r_bias,
                        generator: Optional[torch.Generator] = None):
        """The unfused path: x [B, T, D] in the compute dtype over this
        layer's memory ``mem`` [B, M, D] -> LayerNorm(x + dropout(o_net(
        attention))) [B, T, D].  ``pos_emb`` [M+T, D] is the sinusoid of the
        descending distances, ``mask`` [B, 1, T, M+T] True where blocked;
        with a ``generator`` the probabilities drop at ``attention_dropout``
        and the projection at ``dropout``."""
        cfg = self.cfg
        b, t, d = x.shape
        h = cfg.num_heads
        dh = d // h
        hd = h * dh
        dtype = x.dtype
        w_qkv = self.qkv_net.weight.to(dtype)
        cat = torch.cat([mem.to(dtype), x], dim=1)
        klen = cat.shape[1]
        q = F.linear(x, w_qkv[:hd]).reshape(b, t, h, dh)
        kv = F.linear(cat, w_qkv[hd:])
        k = kv[..., :hd].reshape(b, klen, h, dh)
        v = kv[..., hd:].reshape(b, klen, h, dh)
        r = F.linear(pos_emb, self.r_net.weight.to(dtype)).reshape(klen, h, dh)
        ac = torch.einsum("bihd,bjhd->bhij", q + r_w_bias.to(dtype), k)
        bd = rel_shift(torch.einsum("bihd,jhd->bhij",
                                    q + r_r_bias.to(dtype), r))
        score = (ac + bd).float() * (1.0 / dh ** 0.5)
        probs = torch.softmax(score.masked_fill(mask, float("-inf")), dim=-1)
        probs = plain_dropout(probs, cfg.attention_dropout, generator)
        vec = torch.einsum("bhij,bjhd->bihd", probs.to(dtype), v)
        out = F.linear(vec.reshape(b, t, hd), self.o_net.weight.to(dtype))
        out = plain_dropout(out, cfg.dropout, generator)
        return _layer_norm(x.float() + out.float(), self.layer_norm).to(dtype)


class PositionwiseFF(nn.Module):
    """Reference ``pos_ff``; CoreNet keeps the reference's module indices
    (Linear, ReLU, Dropout, Linear) so the weights sit at CoreNet.0 / .3."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.CoreNet = nn.ModuleList([
            Linear(cfg.units, cfg.inner_size), nn.ReLU(), nn.Identity(),
            Linear(cfg.inner_size, cfg.units)])
        self.layer_norm = LayerNorm(cfg.units)

    def forward_unfused(self, x, p: float,
                        generator: Optional[torch.Generator] = None):
        """The unfused path: LayerNorm(x + drop(W2 drop(relu(W1 x + b1)) +
        b2)) over x [B, T, D], in x's dtype, the sum and LayerNorm in f32."""
        dtype = x.dtype
        ff = self.CoreNet
        h = torch.relu(F.linear(x, ff[0].weight.to(dtype)) +
                       ff[0].bias.to(dtype))
        h = plain_dropout(h, p, generator)
        h = F.linear(h, ff[3].weight.to(dtype)) + ff[3].bias.to(dtype)
        h = plain_dropout(h, p, generator)
        return _layer_norm(x.float() + h.float(), self.layer_norm).to(dtype)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.dec_attn = RelMultiHeadAttention(cfg)
        self.pos_ff = PositionwiseFF(cfg)

    def forward(self, x, psi, r_w_bias, r_r_bias, reset, same_length: bool,
                memory: Optional[Memory] = None, layer_idx: int = 0,
                attn_seed: Optional[int] = None,
                ffn_seed: Optional[int] = None):
        fuse_o = o_in_ffn()
        o = self.dec_attn(x, psi, r_w_bias, r_r_bias, reset, same_length,
                          memory, layer_idx, attn_seed, project=not fuse_o)
        ln1, ff, ln2 = self.dec_attn.layer_norm, self.pos_ff.CoreNet, \
            self.pos_ff.layer_norm
        block = (ff[0].weight.t(), ff[0].bias, ff[3].weight.t(), ff[3].bias,
                 ln1.weight, ln1.bias, ln2.weight, ln2.bias)
        drop = dict(seed=ffn_seed or 0, dropout_p=self.dec_attn.cfg.dropout,
                    train=ffn_seed is not None)
        if fuse_o:  # o is the attention vector; o_net runs in the kernel
            return ffn_block_fused_o(x, o, self.dec_attn.o_net.weight.t(),
                                     *block, **drop)
        return ffn_block(x, o, *block, **drop)

    def forward_unfused(self, x, mem, pos_emb, mask, r_w_bias, r_r_bias,
                        generator: Optional[torch.Generator] = None):
        """The unfused path's layer over x [B, T, D]: attention (with its
        residual and LayerNorm), then the position-wise FFN block."""
        x = self.dec_attn.forward_unfused(x, mem, pos_emb, mask, r_w_bias,
                                          r_r_bias, generator)
        return self.pos_ff.forward_unfused(x, self.dec_attn.cfg.dropout,
                                           generator)


class _WordEmbedding(nn.Module):
    def __init__(self, vocab_size: int, d_model: int):
        super().__init__()
        self.emb_layers = nn.ModuleList([Embedding(vocab_size, d_model)])


class _Crit(nn.Module):
    def __init__(self, vocab_size: int, d_model: int):
        super().__init__()
        self.out_layers = nn.ModuleList([Linear(d_model, vocab_size)])


class TransformerXL(nn.Module):
    """The LM.  ``forward`` -> hidden [B, T, D] (and the new memory);
    ``logits`` projects hidden states through the tied embedding.
    Parameters are uninitialized until ``init_parameters`` or
    ``load_state_dict``.  ``dtype``: the compute dtype (None: the
    parameters' dtype).  ``attn_impl`` is ``resolve_attn_impl(cfg)``: the
    kernel path takes a ring ``Memory`` and a ``DropoutDraw``, the unfused
    path a dense ``Memory`` and a ``torch.Generator`` on the tokens'
    device."""

    def __init__(self, vocab_size: int, cfg: ModelConfig = ModelConfig(),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.attn_impl = resolve_attn_impl(cfg)
        self.dtype = dtype
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

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.dtype or self.embedding.dtype

    def forward(self, tokens: torch.Tensor,
                reset: Optional[torch.Tensor] = None, *,
                memory: Optional[Memory] = None,
                same_length: bool = False, return_hiddens: bool = False,
                dropout: Optional[DropoutDraw] = None):
        """tokens [B, T] -> hidden [B, T, D]; with ``memory``, (hidden,
        new_memory).  ``return_hiddens`` appends the per-layer hiddens: L+1
        tensors [B, D, T], the input of every layer (the first after the
        embedding dropout) followed by the last layer's output.  With
        ``dropout`` (``draw_dropout``) the forward drops as the reference
        does with ``deterministic=False``.

        ``memory`` (``init_memory``, in the compute dtype) is attended over
        and then advanced by the window: its ring is written IN PLACE and
        the returned ``Memory`` shares the buffer (a dense memory returns a
        new buffer).  Without it (a fresh sequence: prefill) only the
        window is attended.  On the unfused path the hiddens are [B, T, D]
        and ``dropout`` is a ``torch.Generator``."""
        out, hids = self._stack(tokens, reset, memory, same_length, dropout)
        if memory is None:
            return (out, hids) if return_hiddens else out
        new_memory = self.advance_memory(memory, hids)
        return (out, new_memory, hids) if return_hiddens else \
            (out, new_memory)

    def forward_train(self, tokens: torch.Tensor,
                      reset: Optional[torch.Tensor], memory: Memory, *,
                      same_length: bool = False,
                      dropout: Optional[DropoutDraw] = None):
        """The training forward: tokens [B, T] over ``memory`` -> (hidden
        [B, T, D] with autograd, rows): rows are the L+1 per-layer [B, D, T]
        hiddens (every layer's input, the first after the embedding
        dropout, then the last output before the output dropout), detached,
        for ``advance_memory`` once the backward has run.  The ring is not
        written here.  ``dropout``: this forward's draw (None: no
        dropout)."""
        out, hids = self._stack(tokens, reset, memory, same_length, dropout)
        return out, [h.detach() for h in hids]

    def _stack(self, tokens, reset, memory, same_length, dropout=None):
        if memory is not None and memory.dense != (self.attn_impl == "xla"):
            raise ValueError(
                f"the {self.attn_impl} path takes a "
                f"{'dense' if self.attn_impl == 'xla' else 'ring'} memory "
                "(init_memory's dense=)")
        if self.attn_impl == "xla":
            return self._stack_unfused(tokens, reset, memory, same_length,
                                       dropout)
        cfg = self.cfg
        dtype = self.compute_dtype
        t = tokens.shape[1]
        m_cap = 0 if memory is None else memory_capacity(memory)
        if memory is not None and memory.hidden.dtype != dtype:
            raise TypeError(f"memory dtype {memory.hidden.dtype} must equal "
                            f"the compute dtype {dtype}")
        # scaled in the parameters' dtype, then cast, [B, D, T]
        x = embed_bdt(self.embedding, tokens, cfg.units ** 0.5, dtype)
        psi = fused_attention.key_trig_basis(m_cap + t, cfg.units, dtype,
                                             device=tokens.device)
        if m_cap:
            psi = fused_attention.ring_psi(psi, t, memory.count, memory.head)
        drop = dropout is not None and cfg.dropout > 0.0
        if drop:
            # flax's Dropout: inputs / keep_prob where kept, in psi's dtype
            # (the divisor rounded to it, as a weak scalar is)
            keep = dropout.psi_keep.to(psi.device, non_blocking=True)
            psi = torch.where(
                keep, psi / torch.tensor(1.0 - cfg.dropout, dtype=dtype),
                torch.zeros((), dtype=dtype, device=psi.device))
            x = dropout_bdt(x, dropout.emb_seed, cfg.dropout, SALT_EMB)
        attn_drop = dropout is not None and cfg.attention_dropout > 0.0
        hids = [x]
        for i, layer in enumerate(self.layers):
            x = layer(x, psi, self.r_w_bias, self.r_r_bias, reset,
                      same_length, memory, i,
                      dropout.attn_seeds[i] if attn_drop else None,
                      dropout.ffn_seeds[i] if drop else None)
            hids.append(x)
        if drop:
            x = dropout_bdt(x, dropout.out_seed, cfg.dropout, SALT_OUT)
        return x.transpose(1, 2), hids

    def _stack_unfused(self, tokens, reset, memory, same_length,
                       generator=None):
        """The unfused path's stack: -> (output [B, T, D], the L+1 hiddens
        [B, T, D]), the reference's XLA branch."""
        cfg = self.cfg
        dtype = self.compute_dtype
        b, t = tokens.shape
        device = tokens.device
        m_cap = 0 if memory is None else memory_capacity(memory)
        count = 0 if memory is None else memory.count
        # scaled in the parameters' dtype, then cast
        x = (self.embedding[tokens.long()] * cfg.units ** 0.5).to(dtype)
        pos_emb = relative_position_embedding(m_cap + t, cfg.units, dtype,
                                              cfg.clamp_len, device)
        pos_emb = plain_dropout(pos_emb, cfg.dropout, generator)
        mask = build_attention_mask(t, m_cap, count, reset, same_length, b,
                                    device)
        x = plain_dropout(x, cfg.dropout, generator)
        hids = [x]
        for i, layer in enumerate(self.layers):
            mem = memory.hidden[i] if memory is not None else \
                x.new_zeros((b, 0, cfg.units))
            x = layer.forward_unfused(x, mem, pos_emb, mask, self.r_w_bias,
                                      self.r_r_bias, generator)
            hids.append(x)
        return plain_dropout(x, cfg.dropout, generator), hids

    @staticmethod
    def advance_memory(memory: Memory, hids) -> Memory:
        """Write each layer's [B, D, T] rows into ring slab head // T, in
        place; count and head advance by T.  A dense memory takes [B, T, D]
        rows and shifts into a new buffer (``shift_memory``)."""
        m_cap = memory_capacity(memory)
        if memory.dense:
            t = hids[0].shape[1]
            return Memory(shift_memory(memory.hidden, torch.stack(hids)),
                          min(memory.count + t, m_cap), 0, dense=True)
        if m_cap == 0:
            return memory
        t = hids[0].shape[2]
        if memory.hidden.shape[4] != t:
            raise ValueError(f"window {t} must equal the ring's slab length "
                             f"{memory.hidden.shape[4]} (init_memory's "
                             "block_len)")
        block = memory.head // t
        for i, rows in enumerate(hids):
            ring_write_layer(memory.hidden, rows, i, block)
        return Memory(memory.hidden, min(memory.count + t, m_cap),
                      (memory.head + t) % m_cap)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Tied-embedding output projection, in f32."""
        return hidden.float() @ self.embedding.float().t() + \
            self.out_bias.float()


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token negative log-likelihood [B, T] of the f32 ``logits``
    [B, T, V] (the unfused path's NLL; the kernel path fuses it with the
    output projection, ``ops.fused_nll``)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0]


def gumbel_softmax(logits: torch.Tensor, temperature: float,
                   generator: Optional[torch.Generator] = None, *,
                   u_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Straight-through Gumbel-softmax over the last axis: the hard one-hot
    of the perturbed argmax in the forward, the soft sample's gradient in
    the backward.  ``u_noise`` gives the uniform draw (a test shares one
    with the reference); otherwise it is drawn from ``generator`` on the
    logits' device."""
    eps = 1e-20
    u = torch.rand(logits.shape, generator=generator, device=logits.device) \
        if u_noise is None else u_noise
    g = -torch.log(-torch.log(u + eps) + eps)
    y = torch.softmax((logits + g) / temperature, dim=-1)
    hard = F.one_hot(y.argmax(dim=-1), logits.shape[-1]).to(y.dtype)
    return (hard - y).detach() + y


def forward_generate_gumbel(model: TransformerXL, tokens: torch.Tensor,
                            memory: Memory, temperature: float,
                            generator: Optional[torch.Generator] = None, *,
                            u_noise: Optional[torch.Tensor] = None):
    """(one-hot Gumbel samples [B, T, V], the new memory): the forward over
    ``memory`` (advanced as ``forward`` advances it), the tied logits, then
    ``gumbel_softmax``."""
    hidden, new_memory = model(tokens, memory=memory)
    return gumbel_softmax(model.logits(hidden), temperature, generator,
                          u_noise=u_noise), new_memory
