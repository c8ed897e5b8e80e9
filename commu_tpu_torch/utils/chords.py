"""Chord-symbol arithmetic used by key augmentation.

``sync_key_augment`` transposes a chord progression from the original key to an
augmented key, reproducing the reference's (idiosyncratic) pitch-class table in
which flat roots resolve enharmonically and transposed roots are re-spelled with
a fixed mixed sharp/flat preference (reference:
commu/preprocessor/utils/utils.py:37-96).

A copy of ``commu_tpu/utils/chords.py``.
"""
from __future__ import annotations

import re
from typing import List

# Pitch-class indices relative to A (a=0 .. g#=11), with the reference's
# enharmonic assignments for flat spellings (note: deliberately NOT all exact
# enharmonics — ab maps to 11 (=g#), bb to 1 (=a#), db to 4 (=c#), eb to 6
# (=d#), gb to 9 (=f#)).
CHORD_TO_SYMBOL = {
    "a": 0, "a#": 1, "b": 2, "c": 3, "c#": 4, "d": 5,
    "d#": 6, "e": 7, "f": 8, "f#": 9, "g": 10, "g#": 11,
    "ab": 11, "bb": 1, "db": 4, "eb": 6, "gb": 9,
}
# Reverse lookup: flat spellings win for the five aliased pitch classes
# (insertion order above makes the flat entry the last writer).
SYMBOL_TO_CHORD = {}
for _name, _pc in CHORD_TO_SYMBOL.items():
    SYMBOL_TO_CHORD[_pc] = _name

_ROOT_RE = re.compile(r"[A-G](#|b|)")


def sync_key_augment(chords: List[str], aug_key: str, origin_key: str) -> List[List[str]]:
    """Transpose ``chords`` from ``origin_key`` to ``aug_key``.

    Args:
        chords: chord names like ``["C", "Am7", "F", "G"]`` (case-insensitive roots).
        aug_key: target key root, lowercase, e.g. ``"d#"`` or ``"ab"``.
        origin_key: original key root, lowercase (the reference passes the first
            character of e.g. ``"cmajor"`` → ``"c"``).

    Returns:
        A single-element list wrapping the transposed progression (the reference
        returns ``[new_chord_lst]`` to mimic the csv's ``chord_progressions``
        column shape).
    """
    roots = []
    for chord in chords:
        match = _ROOT_RE.match(chord)
        roots.append(match[0])
    qualities = [chord.replace(root, "") for chord, root in zip(chords, roots)]
    pcs = [CHORD_TO_SYMBOL[root.lower()] for root in roots]

    shift = CHORD_TO_SYMBOL[origin_key] - CHORD_TO_SYMBOL[aug_key]
    if shift < 0:
        new_pcs = [(pc + abs(shift)) % 12 for pc in pcs]
    else:
        new_pcs = [(pc - abs(shift)) % 12 for pc in pcs]

    new_roots = [SYMBOL_TO_CHORD[pc] for pc in new_pcs]
    return [[root + quality for root, quality in zip(new_roots, qualities)]]
