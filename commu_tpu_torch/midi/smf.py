"""Standard MIDI File (SMF) reader/writer — self-contained, no external deps.

This replaces the reference's miditoolkit/pretty_midi/mido dependency stack
(reference: commu/preprocessor/encoder/encoder_utils.py:216-232,385-497 uses
miditoolkit for MIDI I/O).  Only the features the ComMU data model needs are
implemented: note on/off, tempo, time signature, key signature, track name,
marker, program change.

A copy of ``commu_tpu/midi/smf.py``.  Its native (C++) parser, a byte copy
of the original's source in ``native/``, is built with ``g++`` at first use
(``_native_build``; no committed binary) and parses by default, as the
original's does when its library is present; ``COMMU_TPU_NO_NATIVE=1``
selects the Python parser.

Object model mirrors the familiar miditoolkit surface (Note/Instrument/
TempoChange/TimeSignature/KeySignature/Marker + MidiFile) so porting user code
is mechanical.
"""
from __future__ import annotations

import ctypes
import os
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np


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
# Native parser (native/smf_native.cpp, built at first use by _native_build)
# ---------------------------------------------------------------------------

_NATIVE_LIB = None  # None = not probed yet; False = switched off


def _load_native():
    global _NATIVE_LIB
    if _NATIVE_LIB is not None:
        return _NATIVE_LIB or None
    if os.environ.get("COMMU_TPU_NO_NATIVE"):
        _NATIVE_LIB = False
        return None
    from . import _native_build

    lib = ctypes.CDLL(str(_native_build.build()))
    lib.smf_parse.restype = ctypes.c_void_p
    lib.smf_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.smf_error.restype = ctypes.c_char_p
    lib.smf_error.argtypes = [ctypes.c_void_p]
    for name in ("smf_num_notes", "smf_num_programs", "smf_num_tempo",
                 "smf_num_timesig", "smf_num_keysig", "smf_num_markers",
                 "smf_num_tracks"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.smf_ticks_per_beat.restype = ctypes.c_int32
    lib.smf_ticks_per_beat.argtypes = [ctypes.c_void_p]
    lib.smf_marker_time.restype = ctypes.c_int64
    lib.smf_marker_time.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.smf_marker_text.restype = ctypes.c_char_p
    lib.smf_marker_text.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.smf_track_name.restype = ctypes.c_char_p
    lib.smf_track_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.smf_free.argtypes = [ctypes.c_void_p]
    _i32 = ctypes.POINTER(ctypes.c_int32)
    _i64 = ctypes.POINTER(ctypes.c_int64)
    _f64 = ctypes.POINTER(ctypes.c_double)
    lib.smf_notes.argtypes = [ctypes.c_void_p, _i32, _i64]
    lib.smf_programs.argtypes = [ctypes.c_void_p, _i32]
    lib.smf_tempo.argtypes = [ctypes.c_void_p, _f64, _i64]
    lib.smf_timesig.argtypes = [ctypes.c_void_p, _i32, _i32, _i64]
    lib.smf_keysig.argtypes = [ctypes.c_void_p, _i32, _i32, _i64]
    _NATIVE_LIB = lib
    return lib


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


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
        lib = _load_native()
        if lib is not None:
            self._parse_native(lib, blob)
        else:
            self._parse_python(blob)

    def _parse_native(self, lib, blob: bytes) -> None:
        # the original's reading of the library's arrays, through Python
        # lists (``tolist``) in place of one numpy scalar per value: the
        # same objects, without most of the per-note conversion cost
        handle = lib.smf_parse(blob, len(blob))
        try:
            err = lib.smf_error(handle)
            if err:
                raise ValueError(err.decode())
            self.ticks_per_beat = lib.smf_ticks_per_beat(handle)

            n = lib.smf_num_notes(handle)
            meta = np.empty(4 * n, dtype=np.int32)
            times = np.empty(2 * n, dtype=np.int64)
            if n:
                lib.smf_notes(handle, _i32p(meta), _i64p(times))
            # track, channel, pitch, velocity; start, end
            meta = meta.reshape(n, 4).tolist()
            times = times.reshape(n, 2).tolist()

            np_ = lib.smf_num_programs(handle)
            progs = np.empty(3 * np_, dtype=np.int32)
            if np_:
                lib.smf_programs(handle, _i32p(progs))
            program = {(t, c): p for t, c, p in progs.reshape(np_, 3).tolist()}

            names = [lib.smf_track_name(handle, i).decode("latin-1")
                     for i in range(lib.smf_num_tracks(handle))]

            # group notes per (track, channel), in (track, channel) order,
            # as the python parser groups a track's notes by channel
            groups = {}
            for idx, (track, channel, _, _) in enumerate(meta):
                groups.setdefault((track, channel), []).append(idx)
            for (track, channel), idxs in sorted(groups.items()):
                notes = [Note(velocity=meta[i][3], pitch=meta[i][2],
                              start=times[i][0], end=times[i][1])
                         for i in idxs]
                notes.sort(key=lambda nn: (nn.start, nn.pitch))
                self.instruments.append(Instrument(
                    program=program.get((track, channel), 0),
                    is_drum=(channel == 9),
                    name=names[track] if track < len(names) else "",
                    notes=notes))

            nt = lib.smf_num_tempo(handle)
            bpm = np.empty(nt, dtype=np.float64)
            tt = np.empty(nt, dtype=np.int64)
            if nt:
                lib.smf_tempo(handle, _f64p(bpm), _i64p(tt))
            self.tempo_changes = [TempoChange(tempo=b, time=t)
                                  for b, t in zip(bpm.tolist(), tt.tolist())]

            nts = lib.smf_num_timesig(handle)
            num = np.empty(nts, dtype=np.int32)
            den = np.empty(nts, dtype=np.int32)
            st = np.empty(nts, dtype=np.int64)
            if nts:
                lib.smf_timesig(handle, _i32p(num), _i32p(den), _i64p(st))
            self.time_signature_changes = [
                TimeSignature(a, b, t)
                for a, b, t in zip(num.tolist(), den.tolist(), st.tolist())]

            nks = lib.smf_num_keysig(handle)
            sf = np.empty(nks, dtype=np.int32)
            minor = np.empty(nks, dtype=np.int32)
            kt = np.empty(nks, dtype=np.int64)
            if nks:
                lib.smf_keysig(handle, _i32p(sf), _i32p(minor), _i64p(kt))
            for s, m, t in zip(sf.tolist(), minor.tolist(), kt.tolist()):
                major_pc = _SF_TO_MAJOR.get(s, 0)
                key_number = ((major_pc + 9) % 12) + 12 if m else major_pc
                self.key_signature_changes.append(
                    KeySignature(key_number=key_number, time=t))

            for i in range(lib.smf_num_markers(handle)):
                self.markers.append(Marker(
                    text=lib.smf_marker_text(handle, i).decode("latin-1"),
                    time=lib.smf_marker_time(handle, i)))
        finally:
            lib.smf_free(handle)

        self.tempo_changes.sort(key=lambda t: t.time)
        self.time_signature_changes.sort(key=lambda t: t.time)
        self.key_signature_changes.sort(key=lambda k: k.time)
        self.markers.sort(key=lambda m: m.time)

    def _parse_python(self, blob: bytes) -> None:
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
