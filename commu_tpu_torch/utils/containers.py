"""Typed containers for sample metadata.

``MidiMeta`` mirrors the reference's pydantic model (reference:
commu/preprocessor/utils/container.py:23-34); its *field order* defines the
order of the 11 conditional meta tokens, so it must never be re-ordered.
Implemented as a plain dataclass with light validation — no pydantic needed.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Union

# Field order == meta-token encoding order. DO NOT REORDER.
META_FIELD_ORDER = (
    "bpm",
    "audio_key",
    "time_signature",
    "pitch_range",
    "num_measures",
    "inst",
    "genre",
    "min_velocity",
    "max_velocity",
    "track_role",
    "rhythm",
)


@dataclass
class MidiMeta:
    bpm: Union[int, str]  # int, or "unknown"
    audio_key: str
    time_signature: str
    pitch_range: str
    num_measures: Union[float, str]
    inst: str
    genre: str
    min_velocity: Union[int, str]
    max_velocity: Union[int, str]
    track_role: str
    rhythm: str

    def __post_init__(self):
        # Coerce numeric strings the way pydantic would ("70" -> 70), while
        # keeping the "unknown" sentinel as-is.
        for field, caster in (("bpm", int), ("num_measures", float),
                              ("min_velocity", int), ("max_velocity", int)):
            value = getattr(self, field)
            if isinstance(value, str) and value != "unknown":
                setattr(self, field, caster(value))

    @classmethod
    def field_names(cls) -> tuple:
        return META_FIELD_ORDER

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass
class MidiInfo:
    """Encoded (token-id) metadata + the event-token sequence of one sample."""

    # meta (token ids)
    bpm: int
    audio_key: int
    time_signature: int
    pitch_range: int
    num_measures: int
    inst: int
    genre: int
    min_velocity: int
    max_velocity: int
    track_role: int
    rhythm: int
    # events
    event_seq: List[int]
