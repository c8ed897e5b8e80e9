"""Metadata <-> token codec.

Encodes the 11 ``MidiMeta`` fields (in field order) into conditional tokens in
the 560..728 region, matching the reference's decorator-registry encoder
bit-for-bit (reference: commu/preprocessor/encoder/meta.py:38-250).  Each field
has an *unknown* sentinel token at the region's base offset; known values start
at ``base + 1`` (except BPM, whose binned value starts at 1, and NUM_MEASURES,
which maps {4,5}/{8,9}/{16,17} onto three dedicated tokens).
"""
from __future__ import annotations

import math
from typing import List, Union

from ..utils import constants
from ..utils.containers import META_FIELD_ORDER, MidiMeta
from ..utils.exceptions import UnprocessableMidiError
from .event_tokens import TokenOffset

UNKNOWN = constants.UNKNOWN

# Per-field region base (== the field's unknown-sentinel token id).
FIELD_BASE = {
    "bpm": int(TokenOffset.BPM),
    "audio_key": int(TokenOffset.KEY),
    "time_signature": int(TokenOffset.TS),
    "pitch_range": int(TokenOffset.PITCH_RANGE),
    "num_measures": int(TokenOffset.NUM_MEASURES),
    "inst": int(TokenOffset.INST),
    "genre": int(TokenOffset.GENRE),
    "min_velocity": int(TokenOffset.VELOCITY),
    "max_velocity": int(TokenOffset.VELOCITY),
    "track_role": int(TokenOffset.TRACK_ROLE),
    "rhythm": int(TokenOffset.RHYTHM),
}

_TABLE_FIELDS = {
    "audio_key": constants.KEY_MAP,
    "time_signature": constants.TIME_SIG_MAP,
    "pitch_range": constants.PITCH_RANGE_MAP,
    "inst": constants.INST_MAP,
    "genre": constants.GENRE_MAP,
    "track_role": constants.TRACK_ROLE_MAP,
    "rhythm": constants.RHYTHM_MAP,
}


def _encode_table(field: str, value: str) -> int:
    table = _TABLE_FIELDS[field]
    try:
        return FIELD_BASE[field] + 1 + table[value]
    except KeyError:
        raise UnprocessableMidiError(f"{field} KeyError: {value}")


def encode_bpm(bpm: Union[int, str]) -> int:
    if bpm == UNKNOWN:
        return FIELD_BASE["bpm"]
    binned = min(bpm, constants.MAX_BPM) // constants.BPM_INTERVAL
    if binned == 0:
        binned = 1
    return FIELD_BASE["bpm"] + binned


def encode_num_measures(num_measures: Union[float, str]) -> int:
    if num_measures == UNKNOWN:
        raise UnprocessableMidiError("Unprocessable midi")
    floored = math.floor(num_measures)
    base = FIELD_BASE["num_measures"]
    if floored in (4, 5):
        return base
    if floored in (8, 9):
        return base + 1
    if floored in (16, 17):
        return base + 2
    raise UnprocessableMidiError(f"num measures ValueError: {num_measures}")


def encode_min_velocity(velocity: Union[int, str]) -> int:
    if velocity == UNKNOWN:
        return FIELD_BASE["min_velocity"]
    return FIELD_BASE["min_velocity"] + 1 + math.floor(velocity / constants.VELOCITY_INTERVAL)


def encode_max_velocity(velocity: Union[int, str]) -> int:
    if velocity == UNKNOWN:
        return FIELD_BASE["max_velocity"]
    return FIELD_BASE["max_velocity"] + 1 + math.ceil(velocity / constants.VELOCITY_INTERVAL)


def _encode_field(field: str, value) -> int:
    if field == "bpm":
        return encode_bpm(value)
    if field == "num_measures":
        return encode_num_measures(value)
    if field == "min_velocity":
        return encode_min_velocity(value)
    if field == "max_velocity":
        return encode_max_velocity(value)
    # table-driven fields share the unknown-sentinel convention
    if value == UNKNOWN:
        return FIELD_BASE[field]
    return _encode_table(field, value)


def encode_meta(midi_meta: MidiMeta) -> List[int]:
    """Encode all 11 fields, in ``META_FIELD_ORDER``."""
    return [_encode_field(field, getattr(midi_meta, field)) for field in META_FIELD_ORDER]


def decode_meta_value(field: str, token: int):
    """Inverse of ``_encode_field`` for the fields the decoder needs.

    Used when reconstructing a MIDI file from a generated sequence
    (reference: encoder_utils.py:463-489 reads bpm/key/ts directly off tokens).
    """
    base = FIELD_BASE[field]
    if token == base and field != "bpm":
        return UNKNOWN
    if field == "bpm":
        return (token - base) * constants.BPM_INTERVAL
    if field in _TABLE_FIELDS:
        inverse = {v: k for k, v in _TABLE_FIELDS[field].items()}
        return inverse[token - base - 1]
    if field in ("min_velocity", "max_velocity"):
        return (token - base - 1) * constants.VELOCITY_INTERVAL
    if field == "num_measures":
        return {0: 4, 1: 8, 2: 16}[token - base]
    raise ValueError(f"undecodable field: {field}")


class MetaEncoder:
    """Object facade matching the reference API (meta.py:245-250)."""

    def encode(self, midi_meta: MidiMeta) -> List[int]:
        return encode_meta(midi_meta)
