"""Generation-request container (reference: commu/midi_generator/container.py).

A copy of ``commu_tpu/generation/container.py``, whose package loads JAX.

``GenerationInput`` carries the 11 metadata fields plus sampling knobs and the
chord progression, validates the chord count against the time signature
(container.py:25-33), and derives the teacher-forcing chord tokens/positions
(container.py:36-63) — including the reference's decimal-string positional
arithmetic, reproduced digit-for-digit.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Dict, List, Union

from ..preprocess.event_codec import detect_chord
from ..utils.constants import DEFAULT_POSITION_RESOLUTION
from ..utils.containers import MidiMeta
from ..vocab.event_tokens import TokenOffset, event2word

_POSITION = int(TokenOffset.POSITION)


@dataclasses.dataclass
class GenerationInput(MidiMeta):
    """MidiMeta + sampling/output controls."""

    output_dir: str = "."
    num_generate: int = 1
    top_k: int = 32
    temperature: float = 0.95
    chord_progression: List[str] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        super().__post_init__()
        expected = (self.num_measures - (self.num_measures % 4)) \
            * Fraction(self.time_signature) * 8
        if expected != len(self.chord_progression):
            raise ValueError(
                "num_measures not matched with chord progression length")

    @classmethod
    def from_dict(cls, data: dict) -> "GenerationInput":
        data = dict(data)
        if isinstance(data.get("chord_progression"), str):
            # `-`-separated CLI form (reference: info_preprocessor.py:16-17)
            data["chord_progression"] = data["chord_progression"].split("-")
        return cls(**data)

    def midi_meta(self) -> MidiMeta:
        return MidiMeta(**{f: getattr(self, f) for f in MidiMeta.field_names()})

    @property
    def chord_token_components(self) -> Dict[str, list]:
        """Teacher-forcing chord tokens + their Position tokens
        (reference: container.py:36-63)."""
        beats_per_bar = int(Fraction(self.time_signature) * 4)
        chord_idx_lst, unique_cp = detect_chord(
            self.chord_progression, beats_per_bar)
        resolution = DEFAULT_POSITION_RESOLUTION
        chord_position = []
        for i in chord_idx_lst:
            if isinstance(i, int):
                chord_position.append(_POSITION)
            else:
                # The reference converts the decimal fraction digits of the
                # bar-position float through string surgery; bar-start chords
                # (fraction ".0") land exactly on the Position_1/128 token.
                frac_digits = str(i).split(".")[-1]
                bit_offset = (float(frac_digits) * resolution) / (10 ** len(frac_digits))
                chord_position.append(int(_POSITION + bit_offset))

        chord_token = []
        for chord in unique_cp:
            name = "Chord_" + chord.split("/")[0].split("(")[0]
            chord_token.append(event2word[name])

        return {"chord_token": chord_token, "chord_position": chord_position}


@dataclasses.dataclass
class ModelArguments:
    """(reference: container.py:13-14)"""

    checkpoint_dir: str
