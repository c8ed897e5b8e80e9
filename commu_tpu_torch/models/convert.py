"""Checkpoint and state interop: the JAX package's params tree and
reference-format ``.pt`` files -> the port's state dict; the JAX package's
blocked-ring ``Memory`` <-> the port's.

The port's parameter names ARE the reference's state-dict names (see
``transformer_xl``), so a reference ``.pt`` loads as it is; a flax params
tree (numpy arrays, flax Dense kernels [in, out]) converts by transposing
into torch's [out, in] layout.  A memory crosses as numpy arrays: the
hidden ring [L+1, R, B, D, Tb] (the JAX layout with ``transposed=True``)
and the two scalars ``count`` and ``head``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..config import ModelConfig

from .transformer_xl import Memory


def state_dict_from_flax_params(params_np: dict,
                                cfg: ModelConfig = ModelConfig()
                                ) -> Dict[str, torch.Tensor]:
    """Flax params tree (numpy values) -> the port's state dict (f32)."""

    def arr(x):
        return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))

    def t(x):
        return arr(np.asarray(x).T)

    emb = arr(params_np["embedding"])
    state = {
        "word_emb.emb_layers.0.weight": emb,
        "crit.out_layers.0.weight": emb,  # tied
        "crit.out_layers.0.bias": arr(params_np["out_bias"]),
        "r_w_bias": arr(params_np["r_w_bias"]),
        "r_r_bias": arr(params_np["r_r_bias"]),
    }
    for i in range(cfg.num_layers):
        attn = params_np[f"layer_{i}"]["attn"]
        ff = params_np[f"layer_{i}"]["ff"]
        p = f"layers.{i}"
        state[f"{p}.dec_attn.qkv_net.weight"] = torch.cat(
            [t(attn["q_net"]["kernel"]), t(attn["kv_net"]["kernel"])])
        state[f"{p}.dec_attn.r_net.weight"] = t(attn["r_net"]["kernel"])
        state[f"{p}.dec_attn.o_net.weight"] = t(attn["o_net"]["kernel"])
        state[f"{p}.dec_attn.layer_norm.weight"] = arr(attn["layer_norm"]["scale"])
        state[f"{p}.dec_attn.layer_norm.bias"] = arr(attn["layer_norm"]["bias"])
        state[f"{p}.pos_ff.CoreNet.0.weight"] = t(ff["ff1"]["kernel"])
        state[f"{p}.pos_ff.CoreNet.0.bias"] = arr(ff["ff1"]["bias"])
        state[f"{p}.pos_ff.CoreNet.3.weight"] = t(ff["ff2"]["kernel"])
        state[f"{p}.pos_ff.CoreNet.3.bias"] = arr(ff["ff2"]["bias"])
        state[f"{p}.pos_ff.layer_norm.weight"] = arr(ff["layer_norm"]["scale"])
        state[f"{p}.pos_ff.layer_norm.bias"] = arr(ff["layer_norm"]["bias"])
    return state


def load_reference_pt(path) -> Dict[str, torch.Tensor]:
    """The model state dict of a reference-format ``.pt`` checkpoint (its
    ``model`` entry, or the whole file when it is a bare state dict), on the
    CPU.  Like the reference's loader, the file is trusted (full unpickle)."""
    blob = torch.load(str(path), map_location="cpu", weights_only=False)
    state = blob["model"] if isinstance(blob, dict) and "model" in blob \
        else blob
    return {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}


def memory_from_arrays(hidden, count, head, dtype=torch.float32,
                       device=None) -> Memory:
    """A JAX ``Memory``'s numpy ``hidden`` (blocked ring), ``count`` and
    ``head`` -> the port's ``Memory`` in ``dtype`` (bf16 crosses through
    f32, exactly)."""
    ring = torch.from_numpy(np.array(hidden, dtype=np.float32, copy=True))
    return Memory(ring.to(device=device, dtype=dtype), int(count), int(head))


def memory_to_arrays(memory: Memory) -> Tuple[np.ndarray, int, int]:
    """The port's ``Memory`` -> (hidden as f32 numpy, count, head), the
    fields of a JAX ``Memory`` with ``transposed=True``."""
    return (memory.hidden.detach().float().cpu().numpy(), memory.count,
            memory.head)
