"""Preprocess orchestrator: augment -> encode -> npy concat.

Directory layout, record handling and on-disk output reproduce the reference
(reference: commu/preprocessor/preprocessor.py:82-319):

    root/{split}/raw/              input MIDI
    root/{split}/augmented_tmp/    key-transposed intermediates
    root/{split}/augmented/        key x bpm variants ({id}_{key}_{bpm}.mid)
    root/{split}/npy_tmp/NNNN/     per-chunk input_i.npy / target_i.npy
    root/output_npy/{input,target}_{split}.npy  (object arrays)

Semantics preserved: ONLY augmented variants are encoded (originals are
covered by the 0-semitone/0-bpm variant); parents whose key is not
cmajor/aminor are dropped; the chord progression is re-synced to the
augmented key; rhythm comes from ``sample_rhythm``; the final concat orders
files by STRING-sorted path (``input_10 < input_2``), which is part of the
on-disk contract (preprocessor.py:306-319).

A copy of ``commu_tpu/preprocess/preprocessor.py`` but for the metadata
CSV, which it reads with the standard ``csv`` module where the original
calls ``pandas.read_csv`` (``read_csv_records`` gives the same records,
values of the same types), and for its pool, which spawns its workers
where the original forks them.
"""
from __future__ import annotations

import copy
import csv
import math
import os
import re
import shutil
from ast import literal_eval
from dataclasses import dataclass
from multiprocessing import get_context
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np

from ..midi import smf
from ..utils.chords import sync_key_augment
from ..utils.exceptions import UnprocessableMidiError
from ..vocab.meta_codec import encode_meta
from . import augment
from .event_codec import encode_midi_to_tokens
from .meta_parser import MetaParser

MIDI_EXTENSIONS = (".mid", ".MID", ".midi", ".MIDI")


@dataclass
class EncodingOutput:
    meta: np.ndarray
    event_sequence: np.ndarray


# pandas' default NA spellings (``pandas._libs.parsers.STR_NA_VALUES``)
_NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
_INT_RE = re.compile(r"[+-]?[0-9]+\Z")
_FLOAT_RE = re.compile(
    r"[+-]?([0-9]+\.?[0-9]*|\.[0-9]+)([eE][+-]?[0-9]+)?\Z|[+-]?inf(inity)?\Z",
    re.IGNORECASE)
_BOOLS = {"True": True, "TRUE": True, "true": True,
          "False": False, "FALSE": False, "false": False}


def _column_names(header: List[str]) -> List[str]:
    """pandas' header: ``Unnamed: i`` for a blank name, ``name.k`` for the
    k-th repeat of a name."""
    names: List[str] = []
    for i, name in enumerate(header):
        name = name or f"Unnamed: {i}"
        base, k = name, 0
        while name in names:
            k += 1
            name = f"{base}.{k}"
        names.append(name)
    return names


def _infer_column(cells: List[str]) -> List[Any]:
    """One column's cells as pandas' C parser types them: all integers ->
    int; integers and decimals -> float, a blank cell then nan (also in a
    column of integers); all booleans -> bool (nan in a blank cell); else
    str (nan in a blank cell); a column of blanks is all nan."""
    na = [c in _NA_VALUES for c in cells]
    present = [c.strip() for c, blank in zip(cells, na) if not blank]
    if not present:
        return [math.nan] * len(cells)
    if not any(na) and all(_INT_RE.match(c) for c in present):
        return [int(c) for c in cells]
    if all(_FLOAT_RE.match(c) for c in present):
        return [math.nan if blank else float(c) for c, blank in zip(cells, na)]
    if all(c in _BOOLS for c, blank in zip(cells, na) if not blank):
        return [math.nan if blank else _BOOLS[c] for c, blank in zip(cells, na)]
    return [math.nan if blank else c for c, blank in zip(cells, na)]


def read_csv_records(csv_path: Union[str, Path]) -> List[Dict[str, Any]]:
    """CSV -> list of record dicts, with ``chord_progressions`` literal-eval'd
    (reference: preprocessor.py:129-130 uses pandas converters): the records
    of ``pandas.read_csv(csv_path, converters={"chord_progressions":
    literal_eval}).to_dict("records")``, read with ``csv``.  Blank lines
    are skipped, a short row is padded with blank cells, a long one raises."""
    with open(csv_path, newline="", encoding="utf-8-sig") as fh:
        rows = [row for row in csv.reader(fh) if row]
    if not rows:
        raise ValueError(f"{csv_path}: no columns to parse")
    names = _column_names(rows[0])
    body = rows[1:]
    for line, row in enumerate(body, start=2):
        if len(row) > len(names):
            raise ValueError(f"{csv_path}: expected {len(names)} fields in "
                             f"line {line}, saw {len(row)}")
        row.extend([""] * (len(names) - len(row)))
    columns = []
    for j, name in enumerate(names):
        cells = [row[j] for row in body]
        columns.append([literal_eval(c) for c in cells]
                       if name == "chord_progressions" else _infer_column(cells))
    return [dict(zip(names, values)) for values in zip(*columns)]


def gather_sample_files(*source_dirs: Union[str, Path]) -> Dict[str, str]:
    result: Dict[str, str] = {}
    for source_dir in source_dirs:
        for f in Path(source_dir).rglob("**/*"):
            if f.suffix in MIDI_EXTENSIONS:
                result[f.stem] = str(f)
    return result


def preprocess_midi(sample_info: Dict[str, Any],
                    midi_path: Union[str, Path]) -> Optional[EncodingOutput]:
    """Meta-parse + meta-encode + event-encode one sample
    (reference: preprocessor.py:277-290)."""
    midi_meta = MetaParser().parse(sample_info)
    try:
        encoded_meta = encode_meta(midi_meta)
    except UnprocessableMidiError as e:
        print(f"{e}: {midi_path}")
        return None
    return EncodingOutput(
        meta=np.array(encoded_meta, dtype=object),
        event_sequence=np.array(encode_midi_to_tokens(midi_path, sample_info),
                                dtype=np.int16),
    )


def preprocess_midi_chunk(
    idx_sample_infos_chunk: Tuple[int, Iterable[Dict[str, Any]]],
    sample_id_to_path: Dict[str, str],
    encode_tmp_dir: Union[str, Path],
) -> None:
    """Encode every augmented variant of the chunk's parent records
    (reference: preprocessor.py:190-275)."""
    idx, sample_infos_chunk = idx_sample_infos_chunk
    records = copy.deepcopy(list(sample_infos_chunk))
    parents = {info["id"]: info for info in records}

    records.extend(
        {"id": sample_id, "augmented": True}
        for sample_id in sample_id_to_path
        if sample_id.split("_")[0] in parents
    )

    encode_tmp_dir = Path(encode_tmp_dir)
    for i, info in enumerate(records):
        if not info.get("augmented", False):
            continue  # originals enter via their 0-shift augmented variant
        id_split = info["id"].split("_")
        if len(id_split) <= 1:
            continue  # raw file id (no embedded key/bpm)
        parent_id, audio_key, bpm = id_split

        midi_path = sample_id_to_path[info["id"]]
        sample = copy.deepcopy(parents[parent_id])
        sample["bpm"] = int(bpm)
        if sample["audio_key"] not in ("cmajor", "aminor"):
            continue
        try:
            sample["chord_progressions"] = sync_key_augment(
                sample["chord_progressions"][0],
                audio_key.replace("minor", "").replace("major", ""),
                sample["audio_key"][0],
            )
        except IndexError:
            print(f"chord progression info is unknown: {midi_path}")
            continue
        sample["audio_key"] = audio_key
        sample["rhythm"] = sample.get("sample_rhythm")
        sample["is_incomplete_measure"] = sample["num_measures"] % 4 != 0

        try:
            out = preprocess_midi(sample_info=sample, midi_path=midi_path)
        except (IndexError, TypeError) as e:
            print(f"{e}: {midi_path}")
            continue
        except ValueError:
            print(f"num measures not allowed: {midi_path}")
            continue
        if out is None:
            continue
        output_dir = encode_tmp_dir / f"{idx:04d}"
        output_dir.mkdir(exist_ok=True, parents=True)
        np.save(str(output_dir / f"input_{i}"), out.meta)
        np.save(str(output_dir / f"target_{i}"), out.event_sequence)


def _object_array(items: List) -> np.ndarray:
    """1-D object array whose elements keep their own dtypes (int16 event
    streams / object meta rows) — the reference's on-disk layout, where
    ``np.save`` wraps a ragged list without converting the elements."""
    arr = np.empty(len(items), dtype=object)
    for i, x in enumerate(items):
        arr[i] = x
    return arr


def concat_npy(source_dir: Union[str, Path]) -> Tuple[List, List]:
    """STRING-sorted rglob gather (reference: preprocessor.py:306-319)."""
    def _gather(prefix):
        return sorted(str(f) for f in Path(source_dir).rglob("**/*")
                      if f.suffix == ".npy" and f.stem.startswith(prefix))

    def _load(paths):
        return [np.load(p, allow_pickle=True) for p in paths]

    return _load(_gather("input")), _load(_gather("target"))


def _chunk_worker(args):
    preprocess_midi_chunk(*args)


class Preprocessor:
    """(reference: preprocessor.py:82-168)"""

    def __init__(self, csv_path: Union[str, Path]):
        self.csv_path = csv_path

    def preprocess(self, root_dir: Union[str, Path], num_cores: int,
                   data_split: Tuple[str, ...] = ("train", "val")) -> None:
        root_dir = Path(root_dir)
        output_npy = root_dir / "output_npy"
        output_npy.mkdir(exist_ok=True, parents=True)
        records = read_csv_records(self.csv_path)
        # the native parser is built here, once: the pools' spawned workers
        # only load the library
        smf._load_native()

        for split in data_split:
            split_dir = root_dir / split
            sub = {name: split_dir / name for name in
                   ("raw", "output_npy", "npy_tmp", "augmented_tmp", "augmented")}
            for d in sub.values():
                d.mkdir(exist_ok=True, parents=True)

            augment.augment_data(
                midi_path=sub["raw"], augmented_dir=sub["augmented"],
                augmented_tmp_dir=sub["augmented_tmp"], num_cores=num_cores)

            sample_id_to_path = gather_sample_files(sub["raw"], sub["augmented"])
            self.export_encoded_midi(records, sample_id_to_path,
                                     sub["npy_tmp"], num_cores)

            input_npy, target_npy = concat_npy(sub["npy_tmp"])
            np.save(str(output_npy / f"input_{split}.npy"),
                    _object_array(input_npy), allow_pickle=True)
            np.save(str(output_npy / f"target_{split}.npy"),
                    _object_array(target_npy), allow_pickle=True)

            # clean non-standard dirs (reference: preprocessor.py:164-168)
            for entry in os.listdir(split_dir):
                if entry not in ("raw", "npy_tmp", "augmented", "augmented_tmp"):
                    shutil.rmtree(split_dir / entry)

    def export_encoded_midi(self, records: List[Dict[str, Any]],
                            sample_id_to_path: Dict[str, str],
                            encoded_tmp_dir: Union[str, Path],
                            num_cores: int) -> None:
        chunks = [
            (idx, arr.tolist())
            for idx, arr in enumerate(np.array_split(np.array(records), num_cores))
        ]
        jobs = [(chunk, sample_id_to_path, encoded_tmp_dir) for chunk in chunks]
        if num_cores <= 1 or len(jobs) <= 1:
            for job in jobs:
                _chunk_worker(job)
        else:
            with get_context("spawn").Pool(processes=num_cores) as pool:
                pool.map(_chunk_worker, jobs)
