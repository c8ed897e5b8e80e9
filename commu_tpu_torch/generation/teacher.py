"""Chord/bar teacher-forcing state machine (host reference implementation).

Behavioral replica of the reference's ``TeacherForceTask``
(reference: commu/midi_generator/midi_inferrer.py:16-169): during sampling it
force-feeds structural tokens (Position_1/128 after each Bar, the scheduled
chord tokens at their scheduled positions), bans wrongly-generated chord
tokens, replaces premature EOS with the next scheduled chord anchor, and
converts surplus Bar tokens into EOS.

A copy of ``commu_tpu/generation/teacher.py`` (which cannot be imported
without loading JAX through its package): the oracle for the vectorized
state machine in ``device_sampler``, and the home of
``validate_generated_sequence``.
"""
from __future__ import annotations

import math
from typing import List

from ..utils.constants import DEFAULT_POSITION_RESOLUTION
from ..vocab.event_tokens import TokenOffset

_BAR = int(TokenOffset.BAR)
_EOS = int(TokenOffset.EOS)
_POSITION = int(TokenOffset.POSITION)
_CHORD_START = int(TokenOffset.CHORD_START)
_CHORD_END = int(TokenOffset.CHORD_END)


class TeacherForcer:
    def __init__(self, input_data):
        self.input_data = input_data
        self.next_tokens_forced: List[int] = []
        self.wrong_tokens: List[int] = []
        self.no_sequence_appended = False
        self.is_incomplete = input_data.num_measures % 4 != 0
        self.incomplete_filled = not self.is_incomplete

        components = input_data.chord_token_components
        self.chord_token = list(components["chord_token"])
        self.chord_position = list(components["chord_position"])
        assert len(self.chord_token) == len(self.chord_position), "Wrong Chord Length"
        self.chord_length = len(self.chord_token)
        # flag True for chords NOT at a bar start (forced mid-bar)
        self.inter_chord_flags = [pos != _POSITION for pos in self.chord_position]

    # -- checks (midi_inferrer.py:35-114) --------------------------------
    def check_first_position(self, seq) -> bool:
        return self.incomplete_filled and seq[-1] == _BAR

    def check_remnant_chord(self) -> bool:
        return bool(len(self.chord_token) * len(self.chord_position))

    def check_length_fit(self) -> bool:
        return self.chord_length == int(self.input_data.num_measures // 4 * 4)

    def check_position_fit(self, seq) -> bool:
        return seq[-2] == _BAR and seq[-1] == _POSITION

    def check_one_chord_per_bar_case(self, seq) -> bool:
        return (self.check_remnant_chord() and self.incomplete_filled
                and self.check_length_fit() and self.check_position_fit(seq))

    def check_mul_chord_per_bar_case(self, seq) -> bool:
        common = (self.check_remnant_chord() and self.incomplete_filled
                  and not self.check_length_fit())
        is_first_position_chord = common and self.check_position_fit(seq)
        is_inter_position_chord = (
            common and not self.check_position_fit(seq)
            and seq[-1] == self.chord_position[0]
            and self.inter_chord_flags[0])
        return is_first_position_chord or is_inter_position_chord

    def check_chord_position_passed(self, token) -> bool:
        if not self.check_remnant_chord():
            return False
        is_position_passed = (
            self.chord_position[0] < token < _POSITION + DEFAULT_POSITION_RESOLUTION
            or token == _BAR)
        return self.inter_chord_flags[0] and is_position_passed

    @staticmethod
    def check_wrong_chord_token_generated(token) -> bool:
        return _CHORD_START <= token <= _CHORD_END

    def check_wrong_eos_generated(self, token) -> bool:
        return self.check_remnant_chord() and token == _EOS

    def check_wrong_bar_token_generated(self, token) -> bool:
        return not self.check_remnant_chord() and token == _BAR

    # -- teaching actions (midi_inferrer.py:116-144) ----------------------
    def teach_first_position(self) -> None:
        self.next_tokens_forced.append(_POSITION)

    def teach_chord_token(self) -> None:
        self.next_tokens_forced.append(self.chord_token.pop(0))
        self.chord_position.pop(0)
        self.inter_chord_flags.pop(0)
        self.wrong_tokens = []

    def teach_chord_position(self) -> None:
        self.next_tokens_forced.append(self.chord_position[0])
        self.wrong_tokens = []

    def teach_wrong_chord_token(self, wrong_token) -> None:
        self.no_sequence_appended = True
        self.wrong_tokens.append(wrong_token)

    def teach_remnant_chord(self) -> None:
        token = self.chord_position[0] if self.inter_chord_flags[0] else _BAR
        self.next_tokens_forced.append(token)

    def teach_eos(self) -> None:
        self.next_tokens_forced.append(_EOS)

    # -- validation (midi_inferrer.py:146-168) ----------------------------
    def validate_teacher_forced_sequence(self, seq) -> None:
        num_bars = seq.count(_BAR)
        num_chord = sum(1 for t in seq if _CHORD_START <= t <= _CHORD_END)
        if len(self.chord_token) != 0:
            raise ValueError(
                f"remnant chord length: {len(self.chord_token)} — "
                "error in teacher forcing")
        if num_bars != int(math.ceil(self.input_data.num_measures)):
            raise ValueError(f"bar length: {num_bars} — error in bar length")
        if num_chord != self.chord_length:
            raise ValueError(
                f"num_chord: {num_chord} vs {self.chord_length} — "
                "error in chord length")


def validate_generated_sequence(seq: List[int]) -> bool:
    """At least one syntactically complete Position/Velocity/Pitch/Duration
    note quad (reference: midi_inferrer.py:322-336)."""
    vel_lo, vel_hi = int(TokenOffset.NOTE_VELOCITY), _CHORD_START
    pos_lo, pos_hi = _POSITION, int(TokenOffset.BPM)
    pitch_lo, pitch_hi = int(TokenOffset.PITCH), int(TokenOffset.NOTE_VELOCITY)
    dur_lo, dur_hi = int(TokenOffset.NOTE_DURATION), _POSITION
    for idx, token in enumerate(seq):
        if idx + 2 > len(seq) - 1:
            break
        if vel_lo <= token < vel_hi:
            if (pos_lo <= seq[idx - 1] < pos_hi
                    and pitch_lo <= seq[idx + 1] < pitch_hi
                    and dur_lo <= seq[idx + 2] < dur_hi):
                return True
    return False
