"""MIDI <-> REMI-token codec.

Token-stream-compatible rebuild of the reference's event encoder/decoder
(reference: commu/preprocessor/encoder/encoder.py:21-96 and
encoder_utils.py:184-497), redesigned around array math instead of per-note
Python object churn: note attributes become numpy vectors, position/duration
binning becomes two vectorized argmins, and the chord/bar scaffold is merged
with the note stream by one stable sort.  Output ids are bit-for-bit identical
to the reference encoder on the same MIDI bytes.
"""
from __future__ import annotations

import math
import sys
from pathlib import Path
from typing import Dict, List, Sequence, Union

import numpy as np

from ..midi import Instrument, KeySignature, Marker, MidiFile, Note, TempoChange, TimeSignature
from ..utils.constants import (
    BPM_INTERVAL,
    DEFAULT_POSITION_RESOLUTION,
    DEFAULT_TICKS_PER_BEAT,
    SIG_TIME_MAP,
    VELOCITY_INTERVAL,
)
from ..utils.containers import MidiInfo
from ..utils.exceptions import UnprocessableMidiError
from ..vocab.event_tokens import TokenOffset, event2word, word2event

NUM_VELOCITY_BINS = int(128 / VELOCITY_INTERVAL)
VELOCITY_BINS = np.linspace(2, 127, NUM_VELOCITY_BINS, dtype=int)

_POSITION = int(TokenOffset.POSITION)
_PITCH = int(TokenOffset.PITCH)
_NOTE_VELOCITY = int(TokenOffset.NOTE_VELOCITY)
_NOTE_DURATION = int(TokenOffset.NOTE_DURATION)
_BAR = int(TokenOffset.BAR)
_EOS = int(TokenOffset.EOS)


def _duration_bins(ticks_per_bar: int) -> np.ndarray:
    step = int(ticks_per_bar / DEFAULT_POSITION_RESOLUTION)
    return np.arange(step, ticks_per_bar + 1, step, dtype=int)


def detect_chord(chord_progression: Sequence[str], beats_per_bar: int):
    """Chord progression (one entry per half-beat) -> (positions, names).

    Positions are fractional bar indices (float); the first chord of every bar
    is always emitted even if unchanged (reference: encoder_utils.py:356-368).
    """
    chords_per_bar = beats_per_bar * 2
    num_measures = int(len(chord_progression) / chords_per_bar)
    split_by_bar = np.array_split(np.array(chord_progression), num_measures)
    chord_idx: List[float] = []
    chord_name: List[str] = []
    for bar_idx, bar in enumerate(split_by_bar):
        for c_idx, chord in enumerate(bar):
            chord = chord.lower()
            if c_idx == 0 or chord != chord_name[-1]:
                chord_idx.append(bar_idx + c_idx / chords_per_bar)
                chord_name.append(chord)
    return chord_idx, chord_name


def _chord_scaffold_tokens(
    chord_progression: List[str],
    ticks_per_bar: int,
    num_measures: int,
    is_incomplete_measure: bool,
    beats_per_bar: int,
):
    """Bar + chord Position/Chord token stream, in reference emission order
    (reference: encoder_utils.py:315-354)."""
    chord_idx_lst, chords = detect_chord(chord_progression, beats_per_bar)
    start_time = ticks_per_bar * int(is_incomplete_measure)
    times: List[int] = []
    tokens: List[int] = []
    head = 0
    for i in range(num_measures):
        times.append(i * ticks_per_bar)
        tokens.append(_BAR)
        while head < len(chord_idx_lst) and chord_idx_lst[head] < i + 1 - is_incomplete_measure:
            chord_position = chord_idx_lst[head]
            chord_time = int(chord_position * ticks_per_bar + start_time)
            chord = chords[head]
            head += 1
            position_value = (
                int((chord_position - i + is_incomplete_measure) * DEFAULT_POSITION_RESOLUTION) + 1
            )
            times.append(chord_time)
            tokens.append(_POSITION + position_value - 1)
            chord_word = "Chord_" + chord.split("/")[0].split("(")[0]
            chord_token = event2word.get(chord_word)
            if chord_token is None:
                # OOV chord: position token stays, chord token is dropped
                # (reference: encoder.py:56-67 else-branch)
                print(f"OOV {chord_word}", file=sys.stderr)
                continue
            times.append(chord_time)
            tokens.append(chord_token)
    return times, tokens


class _NoteAnalysis:
    """Vectorized per-note binning shared by the token and event outputs."""

    __slots__ = ("starts", "ends", "pitches", "velocities", "position_idx",
                 "velocity_idx", "duration_idx", "duration_bins",
                 "ticks_per_bar", "beats_per_bar", "num_measures",
                 "is_incomplete_measure", "chord_progression")


def _analyze_notes(midi, sample_info) -> _NoteAnalysis:
    if not isinstance(midi, MidiFile):
        midi = MidiFile(midi)

    a = _NoteAnalysis()
    a.chord_progression = sample_info["chord_progressions"]
    a.num_measures = math.ceil(sample_info["num_measures"])
    numerator, denominator = (int(x) for x in sample_info["time_signature"].split("/"))
    a.is_incomplete_measure = bool(sample_info["is_incomplete_measure"])

    beats_per_bar_frac = numerator / denominator * 4
    a.ticks_per_bar = int(midi.ticks_per_beat * beats_per_bar_frac)
    a.beats_per_bar = int(a.ticks_per_bar / midi.ticks_per_beat)
    a.duration_bins = _duration_bins(a.ticks_per_bar)

    notes = midi.instruments[0].notes if midi.instruments else []
    if not notes:
        raise UnprocessableMidiError("no notes in first instrument")
    # reference order: sort by (start, pitch); grouping by bar then preserves it
    order = sorted(range(len(notes)), key=lambda i: (notes[i].start, notes[i].pitch))
    a.starts = np.array([notes[i].start for i in order], dtype=np.int64)
    a.ends = np.array([notes[i].end for i in order], dtype=np.int64)
    a.pitches = np.array([notes[i].pitch for i in order], dtype=np.int64)
    a.velocities = np.array([notes[i].velocity for i in order], dtype=np.int64)

    # position binning: per note, nearest of the 128 in-bar grid flags
    bar_index = a.starts // a.ticks_per_bar
    rel = (a.starts - bar_index * a.ticks_per_bar).astype(np.float64)
    step = a.ticks_per_bar / DEFAULT_POSITION_RESOLUTION
    flags = np.arange(DEFAULT_POSITION_RESOLUTION, dtype=np.float64) * step
    a.position_idx = np.argmin(np.abs(rel[:, None] - flags[None, :]), axis=1)

    # velocity binning
    a.velocity_idx = np.searchsorted(VELOCITY_BINS, a.velocities, side="right") - 1

    # duration binning
    durations = (a.ends - a.starts).astype(np.float64)
    a.duration_idx = np.argmin(
        np.abs(durations[:, None] - a.duration_bins[None, :].astype(np.float64)), axis=1)
    return a


def encode_midi_to_tokens(
    midi: Union[str, Path, MidiFile],
    sample_info: Dict,
) -> np.ndarray:
    """MIDI file -> REMI token-id sequence (with trailing EOS).

    Vectorized equivalent of the reference's extract_events + word mapping
    (encoder.py:21-69); identical output ids.
    """
    if not sample_info["chord_progressions"] or not sample_info["chord_progressions"][0]:
        raise UnprocessableMidiError("empty chord progression")
    a = _analyze_notes(midi, sample_info)
    (chord_progression, num_measures, is_incomplete_measure, ticks_per_bar,
     beats_per_bar) = (a.chord_progression, a.num_measures,
                       a.is_incomplete_measure, a.ticks_per_bar,
                       a.beats_per_bar)
    starts, pitches, velocity_idx, position_idx, duration_idx = (
        a.starts, a.pitches, a.velocity_idx, a.position_idx, a.duration_idx)

    position_tok = _POSITION + position_idx
    pitch_tok = _PITCH + pitches
    # OOV velocity (< first bin) falls back to the max-velocity token
    # (reference: encoder.py:58-60)
    velocity_tok = np.where(
        velocity_idx < 0, _NOTE_VELOCITY + NUM_VELOCITY_BINS - 1, _NOTE_VELOCITY + velocity_idx
    )
    duration_tok = _NOTE_DURATION + duration_idx

    note_tokens = np.stack([position_tok, velocity_tok, pitch_tok, duration_tok], axis=1)
    note_times = np.repeat(starts, 4)

    chord_times, chord_tokens = _chord_scaffold_tokens(
        chord_progression[0], ticks_per_bar, num_measures, is_incomplete_measure, beats_per_bar
    )

    all_times = np.concatenate([np.array(chord_times, dtype=np.int64), note_times])
    all_tokens = np.concatenate(
        [np.array(chord_tokens, dtype=np.int64), note_tokens.reshape(-1)]
    )
    # stable sort keeps: chord scaffold before notes at equal time, and the
    # 4-token note groups contiguous (reference: encoder_utils.py:352-354)
    merged = all_tokens[np.argsort(all_times, kind="stable")]

    return np.append(merged, _EOS)


class Event:
    """REMI event object, field-identical to the reference's Event
    (encoder_utils.py:34-44) for the ``for_cp=True`` output mode."""

    __slots__ = ("name", "time", "value", "text")

    def __init__(self, name, time, value, text):
        self.name = name
        self.time = time
        self.value = value
        self.text = text

    def __repr__(self):
        return "Event(name={}, time={}, value={}, text={})".format(
            self.name, self.time, self.value, self.text)

    def __eq__(self, other):
        return (self.name, self.time, self.value, self.text) == (
            getattr(other, "name", None), getattr(other, "time", None),
            getattr(other, "value", None), getattr(other, "text", None))


def encode_midi_to_events(
    midi: Union[str, Path, MidiFile],
    sample_info: Dict,
):
    """MIDI file -> REMI Event-object stream: the reference's
    ``encode(..., for_cp=True)`` mode (encoder.py:48-49), which returns the
    events BEFORE word mapping — raw bin indices (velocity may be the OOV -1)
    and no OOV chord dropping.  Returns None for an empty chord progression
    (extract_events, encoder_utils.py:195-196)."""
    chord_progression = sample_info["chord_progressions"]
    if not chord_progression or not chord_progression[0]:
        return None
    a = _analyze_notes(midi, sample_info)

    note_events = []
    for i in range(len(a.starts)):
        t = int(a.starts[i])
        dur = int(a.ends[i]) - t
        v_idx = int(a.velocity_idx[i])
        d_idx = int(a.duration_idx[i])
        note_events.append(Event(
            "Position", t,
            "{}/{}".format(int(a.position_idx[i]) + 1, DEFAULT_POSITION_RESOLUTION),
            "{}".format(t)))
        # OOV velocity keeps index -1; its text bin is DEFAULT_VELOCITY_BINS[-1]
        # (the reference's negative indexing, encoder_utils.py:268-277)
        note_events.append(Event(
            "Note Velocity", t, v_idx,
            "{}/{}".format(int(a.velocities[i]), int(VELOCITY_BINS[v_idx]))))
        note_events.append(Event(
            "Note On", t, int(a.pitches[i]), "{}".format(int(a.pitches[i]))))
        note_events.append(Event(
            "Note Duration", t, d_idx,
            "{}/{}".format(dur, int(a.duration_bins[d_idx]))))

    # chord/bar scaffold (insert_chord_on_event, encoder_utils.py:315-354);
    # unlike the token path, events keep OOV chords
    chord_idx_lst, chords = detect_chord(chord_progression[0], a.beats_per_bar)
    start_time = a.ticks_per_bar * int(a.is_incomplete_measure)
    chord_events = []
    head = 0
    for i in range(a.num_measures):
        chord_events.append(
            Event("Bar", i * a.ticks_per_bar, None, "{}".format(i + 1)))
        while (head < len(chord_idx_lst)
               and chord_idx_lst[head] < i + 1 - int(a.is_incomplete_measure)):
            chord_position = chord_idx_lst[head]
            chord_time = int(chord_position * a.ticks_per_bar + start_time)
            chord = chords[head]
            head += 1
            chord_events.append(Event(
                "Position", chord_time,
                "{}/{}".format(
                    int((chord_position - i + int(a.is_incomplete_measure))
                        * DEFAULT_POSITION_RESOLUTION) + 1,
                    DEFAULT_POSITION_RESOLUTION),
                chord_time))  # reference passes the int, not str
            name = chord.split("/")[0].split("(")[0]
            chord_events.append(Event("Chord", chord_time, name, name))

    merged = chord_events + note_events
    merged.sort(key=lambda e: e.time)  # stable: scaffold first at equal time
    return merged


def decode_tokens_to_midi(midi_info: MidiInfo) -> MidiFile:
    """Token-id sequence + encoded meta -> MidiFile
    (reference: encoder.py:71-96, encoder_utils.py:385-497)."""
    time_sig = SIG_TIME_MAP[midi_info.time_signature - int(TokenOffset.TS) - 1]
    numerator, denominator = (int(x) for x in time_sig.split("/"))
    beats_per_bar = int(numerator / denominator * 4)
    ticks_per_bar = DEFAULT_TICKS_PER_BEAT * beats_per_bar
    duration_bins = _duration_bins(ticks_per_bar)

    # id stream -> (name, value) event stream; EOS and OOV ids are dropped
    events = []
    for word in midi_info.event_seq:
        word = int(word)
        name_value = word2event.get(word)
        if name_value is None:
            if word != _EOS:
                print(f"OOV: {word}", file=sys.stderr)
            continue
        name, value = name_value.split("_")
        events.append((name, value))

    temp_notes = []
    temp_chords = []
    for i in range(len(events) - 3):
        name, value = events[i]
        if name == "Bar" and i > 0:
            temp_notes.append("Bar")
            temp_chords.append("Bar")
        elif (
            name == "Position"
            and events[i + 1][0] == "Note Velocity"
            and events[i + 2][0] == "Note On"
            and events[i + 3][0] == "Note Duration"
        ):
            position = int(value.split("/")[0]) - 1
            velocity = int(VELOCITY_BINS[int(events[i + 1][1])])
            pitch = int(events[i + 2][1])
            duration = int(duration_bins[int(events[i + 3][1])])
            temp_notes.append([position, velocity, pitch, duration])
        elif name == "Position" and events[i + 1][0] == "Chord":
            position = int(value.split("/")[0]) - 1
            temp_chords.append([position, events[i + 1][1]])

    notes = []
    current_bar = 0
    for entry in temp_notes:
        if entry == "Bar":
            current_bar += 1
            continue
        position, velocity, pitch, duration = entry
        bar_st = current_bar * ticks_per_bar
        bar_et = (current_bar + 1) * ticks_per_bar
        flags = np.linspace(int(bar_st), int(bar_et), DEFAULT_POSITION_RESOLUTION,
                            endpoint=False, dtype=int)
        st = int(flags[position])
        notes.append(Note(velocity=velocity, pitch=pitch, start=st, end=st + duration))

    chords = []
    current_bar = 0
    for entry in temp_chords:
        if entry == "Bar":
            current_bar += 1
            continue
        position, value = entry
        bar_st = current_bar * ticks_per_bar
        bar_et = (current_bar + 1) * ticks_per_bar
        flags = np.linspace(bar_st, bar_et, DEFAULT_POSITION_RESOLUTION,
                            endpoint=False, dtype=int)
        chords.append([int(flags[position]), value])

    midi = MidiFile(ticks_per_beat=DEFAULT_TICKS_PER_BEAT)
    midi.time_signature_changes.append(TimeSignature(numerator, denominator, 0))
    # ComMU key numbering (0-11 major / 12-23 minor) == our key_number space
    midi.key_signature_changes.append(
        KeySignature(key_number=midi_info.audio_key - int(TokenOffset.KEY) - 1)
    )
    midi.tempo_changes.append(
        TempoChange(tempo=(midi_info.bpm - int(TokenOffset.BPM)) * BPM_INTERVAL, time=0)
    )
    inst = Instrument(program=0, is_drum=False)
    inst.notes = notes
    midi.instruments.append(inst)
    for st, value in chords:
        midi.markers.append(Marker(text=value, time=st))
    return midi


class EventSequenceEncoder:
    """Object facade matching the reference API (encoder.py:14-96)."""

    def encode(self, midi_path, sample_info=None, for_cp=False):
        if for_cp:
            return encode_midi_to_events(midi_path, sample_info)
        return encode_midi_to_tokens(midi_path, sample_info)

    def decode(self, midi_info: MidiInfo) -> MidiFile:
        return decode_tokens_to_midi(midi_info)
