from ..config import ModelConfig
from ..vocab.event_tokens import VOCAB_SIZE

from .convert import (load_reference_pt, memory_from_arrays, memory_to_arrays,
                      state_dict_from_flax_params)
from .transformer_xl import (DropoutDraw, Memory, TransformerXL, draw_dropout,
                             forward_generate_gumbel, gumbel_softmax,
                             init_memory, logical_memory_view, memory_capacity,
                             resolve_attn_impl, ring_blocks, token_nll)

__all__ = ["DropoutDraw", "Memory", "ModelConfig", "draw_dropout", "TransformerXL", "VOCAB_SIZE",
           "forward_generate_gumbel", "gumbel_softmax",
           "init_memory", "load_reference_pt", "logical_memory_view",
           "memory_capacity", "memory_from_arrays", "memory_to_arrays",
           "resolve_attn_impl", "ring_blocks", "state_dict_from_flax_params",
           "token_nll"]
