"""Generated token sequence -> .mid files
(reference: commu/midi_generator/sequence_postprocessor.py:11-57).

A copy of ``commu_tpu/generation/postprocess.py``, whose package loads JAX,
plus ``read_midi`` to parse a written file back."""
from __future__ import annotations

from pathlib import Path
from typing import List

from ..midi import MidiFile
from ..preprocess.event_codec import decode_tokens_to_midi
from ..utils.containers import MidiInfo
from .container import GenerationInput

NUM_META = 11


def decode_event_sequence(generation_result: List[int]):
    """QUIRK preserved: meta = seq[1:12], events = seq[13:] — index 12 (the
    first generated token) is dropped (sequence_postprocessor.py:34-46)."""
    encoded_meta = generation_result[1:NUM_META + 1]
    event_sequence = generation_result[NUM_META + 2:]
    return decode_tokens_to_midi(MidiInfo(*encoded_meta, event_seq=event_sequence))


def output_file_path(input_data: GenerationInput, index: int) -> Path:
    stem = f"{input_data.track_role}_{input_data.inst}_{input_data.pitch_range}"
    out_dir = Path(input_data.output_dir) / stem
    out_dir.mkdir(exist_ok=True, parents=True)
    return out_dir / f"{stem}_{index:03d}.mid"


def write_sequences(input_data: GenerationInput,
                    sequences: List[List[int]]) -> Path:
    for idx, seq in enumerate(sequences):
        midi = decode_event_sequence(seq)
        midi.dump(str(output_file_path(input_data, idx)))
    return Path(input_data.output_dir)


def read_midi(path) -> MidiFile:
    """Parse a written .mid file back (raises on a malformed file)."""
    return MidiFile(path)
