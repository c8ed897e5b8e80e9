from commu_tpu.config import ModelConfig
from commu_tpu.vocab.event_tokens import VOCAB_SIZE

from .convert import load_reference_pt, state_dict_from_flax_params
from .transformer_xl import TransformerXL

__all__ = ["ModelConfig", "TransformerXL", "VOCAB_SIZE", "load_reference_pt",
           "state_dict_from_flax_params"]
