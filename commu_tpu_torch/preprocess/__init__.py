"""Token <-> MIDI event codec (a copy of ``commu_tpu/preprocess/event_codec.py``;
the rest of the preprocessing pipeline is not part of this package)."""
from .event_codec import EventSequenceEncoder, decode_tokens_to_midi, encode_midi_to_tokens  # noqa: F401
