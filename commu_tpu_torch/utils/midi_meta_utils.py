"""MIDI metadata scanning helpers (reference: commu/preprocessor/utils/utils.py:12-35).

Used when deriving metadata straight from MIDI bytes (the main pipeline takes
metadata from the CSV, but these complete the reference's utility surface for
users building their own corpora).  A copy of
``commu_tpu/utils/midi_meta_utils.py``, on this package's own ``midi``."""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

from ..midi import MidiFile
from .constants import CHORD_TRACK_NAME, UNKNOWN


def get_velocity_range(
    midi_path: Union[str, Path],
    keyswitch_velocity: Optional[int] = None,
) -> Tuple[Union[int, str], Union[int, str]]:
    """(min, max) note velocity across non-chord tracks, skipping keyswitch
    markers; (unknown, unknown) when no usable notes exist."""
    midi = MidiFile(str(midi_path))
    velocities = []
    for track in midi.instruments:
        if track.name == CHORD_TRACK_NAME:
            continue
        for note in track.notes:
            if keyswitch_velocity is not None and note.velocity == keyswitch_velocity:
                continue
            velocities.append(note.velocity)
    if not velocities or max(velocities) == 0:
        return UNKNOWN, UNKNOWN
    return min(velocities), max(velocities)


def get_time_signature(midi_path: Union[str, Path]) -> Tuple[int, int]:
    """(numerator, denominator) of the file's first time signature."""
    ts = MidiFile(str(midi_path)).time_signature_changes[0]
    return ts.numerator, ts.denominator
