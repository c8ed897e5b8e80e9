"""Shared constants of the ComMU data model.

The *values* here form the data contract with the reference implementation
(reference: commu/preprocessor/utils/constants.py:22-176); the token ids derived
from these maps must be bit-for-bit identical so that npy corpora and trained
checkpoints are interchangeable between the two stacks.
"""
from __future__ import annotations

# ---------------------------------------------------------------------------
# Intervals / resolutions
# ---------------------------------------------------------------------------
BPM_INTERVAL = 5
CHORD_TRACK_NAME = "chord"
DEFAULT_NUM_BEATS = 4
DEFAULT_POSITION_RESOLUTION = 128
DEFAULT_TICKS_PER_BEAT = 480
MAX_BPM = 200
NUM_BPM_AUGMENT = 2  # -> bpm shifts in [-2, +2] * BPM_INTERVAL
NUM_KEY_AUGMENT = 6  # -> semitone shifts in [-6, +5]
UNKNOWN = "unknown"
VELOCITY_INTERVAL = 2

# MIDI key-signature numbering: 0-11 major (C..B), 12-23 minor (c..b).
MAJOR_KEY = list(range(0, 12))
MINOR_KEY = list(range(12, 24))

# ---------------------------------------------------------------------------
# Metadata value -> small-integer maps (offsets applied by the meta codec)
# ---------------------------------------------------------------------------
_KEY_NAMES = ["c", "c#", "d", "d#", "e", "f", "f#", "g", "g#", "a", "a#", "b"]
_FLAT_ALIAS = {"c#": "db", "d#": "eb", "f#": "gb", "g#": "ab", "a#": "bb"}


def _build_key_map() -> dict:
    key_map = {}
    for mode_idx, mode in enumerate(("major", "minor")):
        for num, name in enumerate(_KEY_NAMES):
            key_map[f"{name}{mode}"] = mode_idx * 12 + num
            if name in _FLAT_ALIAS:
                key_map[f"{_FLAT_ALIAS[name]}{mode}"] = mode_idx * 12 + num
    return key_map


KEY_MAP = _build_key_map()
# Reverse map keeps the *sharp* spelling (matches the reference's dict-comprehension
# order where the sharp entry is inserted first and the flat alias overwrites ...
# actually in the reference the flat alias comes *after* the sharp in KEY_MAP, so
# {v: k} keeps the last writer = the flat name only for keys that have an alias.
KEY_NUM_MAP = {}
for _k, _v in KEY_MAP.items():
    KEY_NUM_MAP[_v] = _k

TIME_SIG_MAP = {
    "4/4": 0,
    "3/4": 1,
    "6/8": 2,
    "12/8": 3,
}
SIG_TIME_MAP = {v: k for k, v in TIME_SIG_MAP.items()}

PITCH_RANGE_MAP = {
    "very_low": 0,
    "low": 1,
    "mid_low": 2,
    "mid": 3,
    "mid_high": 4,
    "high": 5,
    "very_high": 6,
}

# 61 instrument names -> 9 instrument groups.
INST_MAP = {
    "accordion": 1,
    "acoustic_bass": 3,
    "acoustic_guitar": 3,
    "acoustic_piano": 0,
    "banjo": 3,
    "bassoon": 5,
    "bell": 2,
    "brass_ensemble": 5,
    "celesta": 2,
    "choir": 7,
    "clarinet": 5,
    "drums_full": 6,
    "drums_tops": 6,
    "electric_bass": 3,
    "electric_guitar_clean": 3,
    "electric_guitar_distortion": 3,
    "electric_piano": 0,
    "fiddle": 4,
    "flute": 5,
    "glockenspiel": 2,
    "harp": 3,
    "harpsichord": 0,
    "horn": 5,
    "keyboard": 0,
    "mandolin": 3,
    "marimba": 2,
    "nylon_guitar": 3,
    "oboe": 5,
    "organ": 0,
    "oud": 3,
    "pad_synth": 4,
    "percussion": 6,
    "recorder": 5,
    "sitar": 3,
    "string_cello": 4,
    "string_double_bass": 4,
    "string_ensemble": 4,
    "string_viola": 4,
    "string_violin": 4,
    "synth_bass": 3,
    "synth_bass_808": 3,
    "synth_bass_wobble": 3,
    "synth_bell": 2,
    "synth_lead": 1,
    "synth_pad": 4,
    "synth_pluck": 7,
    "synth_voice": 7,
    "timpani": 6,
    "trombone": 5,
    "trumpet": 5,
    "tuba": 5,
    "ukulele": 3,
    "vibraphone": 2,
    "whistle": 7,
    "xylophone": 2,
    "zither": 3,
    "orgel": 2,
    "synth_brass": 5,
    "sax": 5,
    "bamboo_flute": 5,
    "yanggeum": 3,
    "vocal": 8,
}

GENRE_MAP = {
    "newage": 0,
    "cinematic": 1,
}

TRACK_ROLE_MAP = {
    "main_melody": 0,
    "sub_melody": 1,
    "accompaniment": 2,
    "bass": 3,
    "pad": 4,
    "riff": 5,
}

RHYTHM_MAP = {
    "standard": 0,
    "triplet": 1,
}
