"""The 729-token REMI event space.

This module is the *data contract* with the reference stack: every token id
must match the reference's ``event_tokens.py`` / ``mk_remi_map`` /
``add_flat_chord2map`` / ``abstract_chord_types`` bit-for-bit (reference:
commu/preprocessor/encoder/event_tokens.py:1-329,
commu/preprocessor/encoder/encoder_utils.py:47-182).  Instead of a 300-line
literal list, the layout is generated programmatically from its regular
structure and locked down by golden tests.

Layout (ids):
    0                  pad / BOS
    1                  EOS
    2                  Bar
    3   .. 130         Note On_0..127          (pitch)
    131 .. 194         Note Velocity_0..63
    195 .. 303         Chord_* (12 roots x 9 qualities + Chord_NN)
    304 .. 431         Note Duration_0..127
    432 .. 559         Position_1/128..128/128
    560 .. 728         metadata regions (see TokenOffset / meta_codec)
"""
from __future__ import annotations

import enum
from typing import Dict, Tuple

from ..utils.constants import DEFAULT_POSITION_RESOLUTION


class TokenOffset(enum.IntEnum):
    """Start offset of each token region (values are the contract)."""

    EOS = 1
    BAR = 2
    PITCH = 3
    NOTE_VELOCITY = 131
    CHORD_START = 195
    CHORD_END = 303
    NOTE_DURATION = 304
    POSITION = 432
    BPM = 560
    KEY = 601
    TS = 626
    PITCH_RANGE = 630
    NUM_MEASURES = 638
    INST = 641
    GENRE = 650
    VELOCITY = 653
    TRACK_ROLE = 719
    RHYTHM = 726
    REMI_META_OFFSET = 138
    META_CC_OFFSET = 7
    VOCAB_SIZE = 729


VOCAB_SIZE = int(TokenOffset.VOCAB_SIZE)
PAD_ID = 0
EOS_ID = int(TokenOffset.EOS)
BAR_ID = int(TokenOffset.BAR)

# Chord roots in the reference's (alphabetical-from-a) order, and the 9 chord
# qualities each root carries, in region order.
CHORD_ROOTS = ("a", "a#", "b", "c", "c#", "d", "d#", "e", "f", "f#", "g", "g#")
CHORD_QUALITIES = ("", "7", "+", "dim", "m", "m7", "m7b5", "maj7", "sus4")

# Flat-root chords alias onto the enharmonic sharp root one letter down
# (ab->g#, bb->a#, db->c#, eb->d#, gb->f#).
_FLAT_TO_SHARP = {"ab": "g#", "bb": "a#", "db": "c#", "eb": "d#", "gb": "f#"}

# Extended / abstract qualities normalize onto one of the 9 canonical
# qualities.  NOTE one asymmetry preserved from the reference: for *flat*
# roots "mM7" maps to "m" (add_flat_chord2map) while for *natural* roots it
# maps to "m7" (abstract_chord_types).
_FLAT_QUALITY_ALIAS = {
    "maj": "", "6": "",
    "maj7": "maj7", "add2": "maj7", "sus2": "maj7",
    "7": "7",
    "dim": "dim", "dim7": "dim",
    "+": "+",
    "m": "m", "m6": "m", "mM7": "m",
    "m7": "m7", "madd2": "m7",
    "sus4": "sus4", "7sus4": "sus4",
    "m7b5": "m7b5",
    "": "",
}
_NATURAL_EXTRA_ALIAS = {
    "7sus4": "sus4",
    "m6": "m",
    "sus2": "maj7", "add2": "maj7",
    "6": "",
    "dim7": "dim",
    "madd2": "m7", "mM7": "m7",
}


def _base_events() -> list:
    events = ["Bar_None"]
    events += [f"Note On_{i}" for i in range(128)]
    events += [f"Note Velocity_{i}" for i in range(64)]
    for root in CHORD_ROOTS:
        for quality in CHORD_QUALITIES:
            events.append(f"Chord_{root}{quality}")
    events.append("Chord_NN")
    return events


def build_event2word() -> Dict[str, int]:
    """Event-name -> token-id map, including all chord aliases."""
    events = _base_events()
    events += [f"Note Duration_{i}" for i in range(DEFAULT_POSITION_RESOLUTION)]
    events += [
        f"Position_{i}/{DEFAULT_POSITION_RESOLUTION}"
        for i in range(1, DEFAULT_POSITION_RESOLUTION + 1)
    ]
    e2w = {name: idx for idx, name in enumerate(events, start=2)}

    # Flat-root chord aliases (reference: add_flat_chord2map). Qualities not in
    # the alias table (e.g. "m7b5" is, "NN" is not applicable) map through
    # _FLAT_QUALITY_ALIAS onto a canonical quality of the sharp root.
    for flat, sharp in _FLAT_TO_SHARP.items():
        for quality, canonical in _FLAT_QUALITY_ALIAS.items():
            e2w[f"Chord_{flat}{quality}"] = e2w[f"Chord_{sharp}{canonical}"]

    # Abstract qualities on natural roots (reference: abstract_chord_types).
    for root in ("a", "b", "c", "d", "e", "f", "g"):
        for quality, canonical in _NATURAL_EXTRA_ALIAS.items():
            e2w[f"Chord_{root}{quality}"] = e2w[f"Chord_{root}{canonical}"]

    return e2w


def build_word2event() -> Dict[int, str]:
    """Token-id -> canonical event-name map (aliases excluded)."""
    events = _base_events()
    events += [f"Note Duration_{i}" for i in range(DEFAULT_POSITION_RESOLUTION)]
    events += [
        f"Position_{i}/{DEFAULT_POSITION_RESOLUTION}"
        for i in range(1, DEFAULT_POSITION_RESOLUTION + 1)
    ]
    return {idx: name for idx, name in enumerate(events, start=2)}


# Singleton maps (cheap to build; importers share them).
event2word: Dict[str, int] = build_event2word()
word2event: Dict[int, str] = build_word2event()


def chord_token_range() -> Tuple[int, int]:
    return int(TokenOffset.CHORD_START), int(TokenOffset.CHORD_END)
