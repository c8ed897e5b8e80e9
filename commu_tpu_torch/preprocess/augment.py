"""Key/BPM data augmentation (reference: commu/preprocessor/augment.py).

Per raw MIDI file: 12 key transposes (semitone shifts -6..+5, key-signature
rewrite + pitch shift) x 5 BPM variants (-2..+2 x 5 BPM around the normalized
average tempo) written into ``augmented/`` as ``{id}_{key}_{bpm}.mid``.
Runs on our self-contained SMF layer instead of miditoolkit/pretty_midi;
fan-out uses multiprocessing (serial when num_cores==1).

A copy of ``commu_tpu/preprocess/augment.py``, on this package's own ``midi``;
its pool spawns its workers where the original forks them (a fork of a
process that runs threads, as torch's do, can deadlock).
"""
from __future__ import annotations

import os
from multiprocessing import get_context
from pathlib import Path
from typing import List, Optional, Union

import numpy as np

from ..midi import MidiFile, TempoChange
from ..utils.constants import (
    BPM_INTERVAL,
    KEY_NUM_MAP,
    MAJOR_KEY,
    MINOR_KEY,
    NUM_BPM_AUGMENT,
    NUM_KEY_AUGMENT,
)

MIDI_EXTENSIONS = (".mid", ".MID", ".MIDI", ".midi")


def get_avg_bpm(event_times: np.ndarray, tempo_infos: np.ndarray,
                end_time: float) -> int:
    """Duration-weighted average BPM, floored to the BPM grid
    (reference: augment.py:19-33)."""
    def _normalize(avg):
        return avg - avg % BPM_INTERVAL

    if len(tempo_infos) == 1:
        return _normalize(tempo_infos[-1])

    times = np.concatenate([np.asarray(event_times), [end_time]])
    durations = np.diff(times)
    total = sum(d * b for d, b in zip(durations, tempo_infos))
    return _normalize(int(total / end_time))


def augment_by_key(midi_path: str, augmented_tmp_dir: str,
                   key_change: int) -> Optional[str]:
    """Transpose by ``key_change`` semitones: rewrite every key signature
    within its mode's circular table and shift the melody track's pitches
    (reference: augment.py:36-70).  Returns None when a shifted pitch leaves
    the MIDI range (the dump raises, the variant is skipped)."""
    midi = MidiFile(midi_path)
    midi_id = Path(midi_path).stem

    for ks in midi.key_signature_changes:
        origin = int(ks.key_number)
        if origin < MINOR_KEY[0]:
            table, idx = MAJOR_KEY, origin + key_change
        else:
            table, idx = MINOR_KEY, (origin - MINOR_KEY[0]) + key_change
        if idx >= len(table):
            idx -= len(table)
        ks.key_number = table[idx]  # dump() serializes from key_number

    new_key = KEY_NUM_MAP[midi.key_signature_changes[0].key_number]

    if midi.instruments:
        for note in midi.instruments[0].notes:
            note.pitch = note.pitch + key_change

    out_path = os.path.join(augmented_tmp_dir, f"{midi_id}_{new_key}.mid")
    try:
        midi.dump(out_path)
    except ValueError as e:
        print(e, midi_id)  # exceeds note pitch range
        return None
    return out_path


def _int_bpm(bpm: float) -> int:
    """Truncate like the reference's ``int(origin_bpm)`` (augment.py:83), but
    first snap values within 1e-3 of an integer: MIDI stores tempo as
    microseconds-per-quarter, so an exact 70 BPM reads back as 69.99998833
    and naive truncation would silently shift every BPM bin down by one."""
    nearest = round(bpm)
    return int(nearest) if abs(bpm - nearest) < 1e-3 else int(bpm)


def augment_by_bpm(augment_tmp_midi_path: str, augmented_dir: str,
                   bpm_change: int) -> None:
    """(reference: augment.py:73-85)"""
    midi = MidiFile(augment_tmp_midi_path)
    event_times, origin_bpm = midi.get_tempo_changes()
    if len(origin_bpm) > 1:
        origin_bpm = get_avg_bpm(np.asarray(event_times),
                                 np.asarray(origin_bpm), midi.get_end_time())
    else:
        origin_bpm = origin_bpm[-1]

    name = Path(augment_tmp_midi_path).parts[-1].split(".")[0]
    new_bpm = _int_bpm(origin_bpm) + bpm_change * BPM_INTERVAL
    midi.tempo_changes = [TempoChange(tempo=new_bpm, time=0)]
    midi.dump(os.path.join(augmented_dir, f"{name}_{round(new_bpm)}.mid"))


def augment_data_map(midi_list: List[str], augmented_dir: str,
                     augmented_tmp_dir: str) -> None:
    for midi_path in midi_list:
        for key_change in range(-NUM_KEY_AUGMENT, NUM_KEY_AUGMENT):
            tmp = augment_by_key(midi_path, augmented_tmp_dir, key_change)
            if tmp is not None:
                for bpm_change in range(-NUM_BPM_AUGMENT, NUM_BPM_AUGMENT + 1):
                    augment_by_bpm(tmp, augmented_dir, bpm_change)


def _worker(args):
    augment_data_map(*args)


def augment_data(midi_path: Union[str, Path], augmented_dir: Union[str, Path],
                 augmented_tmp_dir: Union[str, Path], num_cores: int) -> None:
    midifiles: List[str] = []
    for dirpath, _, filenames in os.walk(str(midi_path)):
        midifiles += [os.path.join(dirpath, f) for f in filenames
                      if f.endswith(MIDI_EXTENSIONS)]
    if not midifiles:
        return
    chunks = [c.tolist() for c in np.array_split(np.array(midifiles), num_cores)]
    jobs = [(c, str(augmented_dir), str(augmented_tmp_dir)) for c in chunks if c]
    if num_cores <= 1 or len(jobs) <= 1:
        for job in jobs:
            _worker(job)
    else:
        with get_context("spawn").Pool(processes=num_cores) as pool:
            pool.map(_worker, jobs)
