"""Standard MIDI File (SMF) reader/writer — self-contained, no external deps.

This replaces the reference's miditoolkit/pretty_midi/mido dependency stack
(reference: commu/preprocessor/encoder/encoder_utils.py:216-232,385-497 uses
miditoolkit for MIDI I/O).  Only the features the ComMU data model needs are
implemented: note on/off, tempo, time signature, key signature, track name,
marker, program change.

A copy of ``commu_tpu/midi/smf.py`` without its optional native (C++) parser:
this module always parses in Python.

Object model mirrors the familiar miditoolkit surface (Note/Instrument/
TempoChange/TimeSignature/KeySignature/Marker + MidiFile) so porting user code
is mechanical.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple, Union


# ---------------------------------------------------------------------------
# Containers
# ---------------------------------------------------------------------------


@dataclass
class Note:
    velocity: int
    pitch: int
    start: int  # ticks
    end: int    # ticks

    @property
    def duration(self) -> int:
        return self.end - self.start


@dataclass
class TempoChange:
    tempo: float  # BPM
    time: int     # ticks


@dataclass
class TimeSignature:
    numerator: int
    denominator: int
    time: int  # ticks


@dataclass
class KeySignature:
    key_name: str = "C"
    time: int = 0
    key_number: Optional[int] = None  # 0-11 major, 12-23 minor

    def __post_init__(self):
        if self.key_number is None:
            self.key_number = key_name_to_number(self.key_name)
        else:
            self.key_name = key_number_to_name(self.key_number)


@dataclass
class Marker:
    text: str
    time: int


@dataclass
class Instrument:
    program: int = 0
    is_drum: bool = False
    name: str = ""
    notes: List[Note] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Key signature numbering
# ---------------------------------------------------------------------------
# key_number: 0-11 = C..B major, 12-23 = c..b minor (matches the convention the
# reference's augmentation math assumes via MAJOR_KEY/MINOR_KEY).

_PITCH_NAMES = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]
_NAME_TO_PC = {}
for _pc, _n in enumerate(_PITCH_NAMES):
    _NAME_TO_PC[_n] = _pc
_FLAT_NAMES = {"Db": 1, "Eb": 3, "Gb": 6, "Ab": 8, "Bb": 10, "Cb": 11, "Fb": 4}
_NAME_TO_PC.update(_FLAT_NAMES)

# sharps/flats count (sf) for each major tonic pitch class; ambiguous classes
# use the spelling with fewer accidentals (Db=-5, F#=+6, B=+5).
_MAJOR_SF = {0: 0, 1: -5, 2: 2, 3: -3, 4: 4, 5: -1, 6: 6, 7: 1, 8: -4, 9: 3, 10: -2, 11: 5}
_SF_TO_MAJOR = {sf: pc for pc, sf in _MAJOR_SF.items()}
_SF_TO_MAJOR[-6] = 6   # Gb == F#
_SF_TO_MAJOR[7] = 1    # C# == Db
_SF_TO_MAJOR[-7] = 11  # Cb == B


def key_name_to_number(name: str) -> int:
    """``"C"``/``"Am"``/``"d#m"``/``"Eb"`` -> 0..23.  Also accepts the ComMU
    constants style ``"cmajor"``/``"a#minor"`` (reference KEY_MAP keys,
    constants.py:22-73), which the reference's ``write_midi`` passes straight
    into ``KeySignature(key_name=...)`` (encoder_utils.py:471-473)."""
    name = name.strip()
    low = name.lower()
    if low.endswith(("major", "minor")):
        root = name[:-5].strip()
        root_key = root[0].upper() + root[1:]
        pc = _NAME_TO_PC[root_key]
        return pc + 12 if low.endswith("minor") else pc
    minor = name.endswith("m") or (name[0].islower() and not name.endswith("M"))
    root = name[:-1] if name.endswith(("m", "M")) else name
    root = root.strip()
    root_key = root[0].upper() + root[1:]
    pc = _NAME_TO_PC[root_key]
    return pc + 12 if minor else pc


def key_number_to_name(number: int) -> str:
    pc = number % 12
    return _PITCH_NAMES[pc] + ("m" if number >= 12 else "")


# ---------------------------------------------------------------------------
# Binary helpers
# ---------------------------------------------------------------------------


def _read_varlen(data: bytes, pos: int) -> Tuple[int, int]:
    value = 0
    while True:
        byte = data[pos]
        pos += 1
        value = (value << 7) | (byte & 0x7F)
        if not byte & 0x80:
            return value, pos


def _write_varlen(value: int) -> bytes:
    if value < 0:
        raise ValueError(f"negative delta time: {value}")
    chunks = [value & 0x7F]
    value >>= 7
    while value:
        chunks.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(chunks))


# ---------------------------------------------------------------------------
# MidiFile
# ---------------------------------------------------------------------------


class MidiFile:
    def __init__(self, path: Optional[Union[str, Path]] = None, ticks_per_beat: int = 480):
        self.ticks_per_beat = ticks_per_beat
        self.instruments: List[Instrument] = []
        self.tempo_changes: List[TempoChange] = []
        self.time_signature_changes: List[TimeSignature] = []
        self.key_signature_changes: List[KeySignature] = []
        self.markers: List[Marker] = []
        if path is not None:
            self._parse(Path(path).read_bytes())

    # -- parsing ------------------------------------------------------------

    def _parse(self, blob: bytes) -> None:
        if blob[:4] != b"MThd":
            raise ValueError("not a Standard MIDI File (missing MThd)")
        header_len = struct.unpack(">I", blob[4:8])[0]
        _fmt, ntrks, division = struct.unpack(">HHH", blob[8:14])
        if division & 0x8000:
            raise ValueError("SMPTE time division not supported")
        self.ticks_per_beat = division

        pos = 8 + header_len
        for _ in range(ntrks):
            if blob[pos:pos + 4] != b"MTrk":
                raise ValueError("corrupt track chunk")
            track_len = struct.unpack(">I", blob[pos + 4:pos + 8])[0]
            track_data = blob[pos + 8:pos + 8 + track_len]
            pos += 8 + track_len
            self._parse_track(track_data)

        for inst in self.instruments:
            inst.notes.sort(key=lambda n: (n.start, n.pitch))
        self.tempo_changes.sort(key=lambda t: t.time)
        self.time_signature_changes.sort(key=lambda t: t.time)
        self.key_signature_changes.sort(key=lambda k: k.time)
        self.markers.sort(key=lambda m: m.time)

    def _parse_track(self, data: bytes) -> None:
        tick = 0
        pos = 0
        status = 0
        track_name = ""
        channel_programs = {}
        # active note-ons: (channel, pitch) -> list of (start_tick, velocity)
        active = {}
        notes_by_channel = {}

        def _close_note(channel: int, pitch: int, end_tick: int):
            stack = active.get((channel, pitch))
            if stack:
                start_tick, velocity = stack.pop(0)
                notes_by_channel.setdefault(channel, []).append(
                    Note(velocity=velocity, pitch=pitch, start=start_tick, end=end_tick)
                )

        while pos < len(data):
            delta, pos = _read_varlen(data, pos)
            tick += delta
            byte = data[pos]
            if byte & 0x80:
                status = byte
                pos += 1
            event_type = status & 0xF0
            channel = status & 0x0F

            if status == 0xFF:  # meta event
                meta_type = data[pos]
                length, body_pos = _read_varlen(data, pos + 1)
                body = data[body_pos:body_pos + length]
                pos = body_pos + length
                if meta_type == 0x51 and length == 3:
                    usec_per_quarter = int.from_bytes(body, "big")
                    self.tempo_changes.append(
                        TempoChange(tempo=60_000_000 / usec_per_quarter, time=tick))
                elif meta_type == 0x58 and length >= 2:
                    self.time_signature_changes.append(
                        TimeSignature(numerator=body[0], denominator=2 ** body[1], time=tick))
                elif meta_type == 0x59 and length >= 2:
                    sf = struct.unpack(">b", body[0:1])[0]
                    minor = body[1] == 1
                    major_pc = _SF_TO_MAJOR.get(sf, 0)
                    key_number = ((major_pc + 9) % 12) + 12 if minor else major_pc
                    self.key_signature_changes.append(
                        KeySignature(key_number=key_number, time=tick))
                elif meta_type == 0x03:
                    track_name = body.decode("latin-1")
                elif meta_type == 0x06:
                    self.markers.append(Marker(text=body.decode("latin-1"), time=tick))
                # 0x2F end-of-track and others: ignored
            elif status in (0xF0, 0xF7):  # sysex
                length, body_pos = _read_varlen(data, pos)
                pos = body_pos + length
            elif event_type == 0x90:  # note on
                pitch, velocity = data[pos], data[pos + 1]
                pos += 2
                if velocity == 0:
                    _close_note(channel, pitch, tick)
                else:
                    active.setdefault((channel, pitch), []).append((tick, velocity))
            elif event_type == 0x80:  # note off
                pitch = data[pos]
                pos += 2
                _close_note(channel, pitch, tick)
            elif event_type == 0xC0:  # program change
                channel_programs[channel] = data[pos]
                pos += 1
            elif event_type == 0xD0:  # channel pressure
                pos += 1
            elif event_type in (0xA0, 0xB0, 0xE0):  # aftertouch / CC / pitch bend
                pos += 2
            else:
                raise ValueError(f"unhandled MIDI status byte 0x{status:02x}")

        # close dangling notes at end of track
        for (channel, pitch), stack in list(active.items()):
            for start_tick, velocity in stack:
                notes_by_channel.setdefault(channel, []).append(
                    Note(velocity=velocity, pitch=pitch, start=start_tick, end=tick))

        for channel in sorted(notes_by_channel):
            self.instruments.append(
                Instrument(
                    program=channel_programs.get(channel, 0),
                    is_drum=(channel == 9),
                    name=track_name,
                    notes=sorted(notes_by_channel[channel], key=lambda n: (n.start, n.pitch)),
                )
            )

    # -- writing ------------------------------------------------------------

    def dump(self, path: Union[str, Path]) -> None:
        for inst in self.instruments:
            for note in inst.notes:
                if not 0 <= note.pitch <= 127:
                    raise ValueError(f"pitch {note.pitch} out of MIDI range")

        tracks = [self._meta_track_bytes()]
        for idx, inst in enumerate(self.instruments):
            tracks.append(self._instrument_track_bytes(inst, channel=9 if inst.is_drum else idx % 16))

        out = bytearray()
        out += b"MThd" + struct.pack(">IHHH", 6, 1, len(tracks), self.ticks_per_beat)
        for track in tracks:
            out += b"MTrk" + struct.pack(">I", len(track)) + track
        Path(path).write_bytes(bytes(out))

    def _meta_track_bytes(self) -> bytes:
        events = []  # (tick, sort_order, payload)
        for ts in self.time_signature_changes:
            denom_pow = max(0, int(ts.denominator).bit_length() - 1)
            events.append((ts.time, 0, bytes([0xFF, 0x58, 4, ts.numerator, denom_pow, 24, 8])))
        for ks in self.key_signature_changes:
            minor = ks.key_number >= 12
            major_pc = ((ks.key_number - 12) + 3) % 12 if minor else ks.key_number
            sf = _MAJOR_SF[major_pc]
            events.append((ks.time, 1, bytes([0xFF, 0x59, 2]) + struct.pack(">b", sf) + bytes([1 if minor else 0])))
        for tc in self.tempo_changes:
            usec = int(round(60_000_000 / tc.tempo))
            events.append((tc.time, 2, bytes([0xFF, 0x51, 3]) + usec.to_bytes(3, "big")))
        for marker in self.markers:
            body = marker.text.encode("latin-1", errors="replace")
            events.append((marker.time, 3, bytes([0xFF, 0x06]) + _write_varlen(len(body)) + body))
        return self._serialize_events(events)

    def _instrument_track_bytes(self, inst: Instrument, channel: int) -> bytes:
        events = []
        if inst.name:
            body = inst.name.encode("latin-1", errors="replace")
            events.append((0, 0, bytes([0xFF, 0x03]) + _write_varlen(len(body)) + body))
        events.append((0, 1, bytes([0xC0 | channel, inst.program & 0x7F])))
        for note in inst.notes:
            if not 0 <= note.pitch <= 127:
                # mirror mido's serializer error (the reference's augmentation
                # catches exactly this to reject out-of-range transpositions,
                # augment.py:66-69)
                raise ValueError(
                    f"data byte must be in range 0..127 (pitch {note.pitch})")
            events.append((note.start, 2, bytes([0x90 | channel, note.pitch, max(1, min(127, note.velocity))])))
            events.append((note.end, 2, bytes([0x80 | channel, note.pitch, 64])))
        return self._serialize_events(events)

    @staticmethod
    def _serialize_events(events) -> bytes:
        events.sort(key=lambda e: (e[0], e[1]))
        out = bytearray()
        prev_tick = 0
        for tick, _, payload in events:
            out += _write_varlen(tick - prev_tick) + payload
            prev_tick = tick
        out += _write_varlen(0) + bytes([0xFF, 0x2F, 0x00])
        return bytes(out)

    # -- analysis helpers (pretty_midi-style) -------------------------------

    def get_tempo_changes(self) -> Tuple[List[float], List[float]]:
        """(event_times_seconds, tempi_bpm) — mirrors pretty_midi's API shape
        used by the reference's BPM averaging (augment.py:73-78)."""
        tempi = self.tempo_changes or [TempoChange(tempo=120.0, time=0)]
        times = [self._tick_to_seconds(tc.time, tempi) for tc in tempi]
        return times, [tc.tempo for tc in tempi]

    def get_end_time(self) -> float:
        tempi = self.tempo_changes or [TempoChange(tempo=120.0, time=0)]
        end_tick = max((n.end for inst in self.instruments for n in inst.notes), default=0)
        return self._tick_to_seconds(end_tick, tempi)

    def _tick_to_seconds(self, tick: int, tempi: List[TempoChange]) -> float:
        seconds = 0.0
        prev_tick = 0
        current_bpm = tempi[0].tempo if tempi else 120.0
        for tc in tempi:
            if tc.time >= tick:
                break
            if tc.time > prev_tick:
                seconds += (tc.time - prev_tick) / self.ticks_per_beat * 60.0 / current_bpm
                prev_tick = tc.time
            current_bpm = tc.tempo
        seconds += max(0, tick - prev_tick) / self.ticks_per_beat * 60.0 / current_bpm
        return seconds

    @property
    def max_tick(self) -> int:
        return max((n.end for inst in self.instruments for n in inst.notes), default=0)
