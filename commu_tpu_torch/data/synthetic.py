"""A synthetic ComMU-format training corpus (an ``output_npy`` directory).

The real 11,144-sample corpus is not vendored, so long training runs use
this stand-in: seeded single-track melodies across a spread of note
densities, measure counts, keys and BPMs, written as MIDI with this
package's ``midi`` and run through its meta and event encoders into the npy
layout the train CLI reads (``{input,target}_{train,val}.npy``, object
arrays of int64 token arrays).  The content is synthetic, so its NLL is no
real-corpus figure: a run on it shows that the loss goes down and the
gradient norms stay bounded at full width.

The draws, their order and the layout are those of the JAX package's
``scripts/make_synthetic_corpus.py`` (seed 1111, the first ``val_frac`` of
the clips the val split), so a run on either package's corpus reads the
same arrays.

Usage: ``python -m commu_tpu_torch.data.synthetic OUT_DIR [--n 600]
[--val_frac 0.1]``.  Imports numpy, never torch or JAX.
"""
from __future__ import annotations

import argparse
import os
import random
import tempfile
from typing import List

import numpy as np

from ..midi import (Instrument, KeySignature, MidiFile, Note, TempoChange,
                    TimeSignature)
from ..preprocess.event_codec import EventSequenceEncoder
from ..preprocess.meta_parser import MetaParser
from ..vocab.meta_codec import encode_meta

SEED = 1111
CHORD_POOL = ["C", "F", "G", "Am", "Dm", "Em", "A#"]


def write_melody(path, bpm=70, num_measures=4, numerator=4, denominator=4,
                 key_number=0, seed=0, ticks_per_beat=480, notes_per_bar=4):
    """A seeded single-track melody like a ComMU raw sample: ``notes_per_bar``
    back-to-back notes a bar, pitch 48-84, velocity 40-100."""
    rng = random.Random(seed)
    midi = MidiFile(ticks_per_beat=ticks_per_beat)
    midi.tempo_changes = [TempoChange(tempo=float(bpm), time=0)]
    midi.time_signature_changes = [TimeSignature(numerator, denominator, 0)]
    midi.key_signature_changes = [KeySignature(key_number=key_number)]
    ticks_per_bar = int(ticks_per_beat * numerator / denominator * 4)
    step = ticks_per_bar // notes_per_bar
    inst = Instrument(program=0, name="melody")
    for bar in range(num_measures):
        for k in range(notes_per_bar):
            start = bar * ticks_per_bar + k * step
            inst.notes.append(
                Note(velocity=rng.randint(40, 100), pitch=rng.randint(48, 84),
                     start=start, end=start + step))
    midi.instruments = [inst]
    midi.dump(path)
    return midi


def chord_progression(num_measures=4, numerator=4, denominator=4,
                      seed=0) -> List[str]:
    """One seeded chord of ``CHORD_POOL`` a bar, an entry every eighth."""
    rng = random.Random(seed)
    chords_per_bar = int(numerator / denominator * 4) * 2
    progression = []
    for _ in range(num_measures):
        progression.extend([rng.choice(CHORD_POOL)] * chords_per_bar)
    return progression


def sample_info(num_measures=4, time_signature="4/4", seed=0,
                **overrides) -> dict:
    """A metadata record of the reference CSV's columns for such a clip."""
    numerator, denominator = (int(x) for x in time_signature.split("/"))
    info = dict(
        id=f"commu{seed:05d}",
        bpm=70,
        audio_key="cmajor",
        chord_progressions=[chord_progression(num_measures, numerator,
                                              denominator, seed)],
        time_signature=time_signature,
        pitch_range="mid",
        num_measures=float(num_measures),
        inst="acoustic_piano",
        genre="newage",
        min_velocity=40,
        max_velocity=100,
        track_role="main_melody",
        rhythm="standard",
        sample_rhythm="standard",
        is_incomplete_measure=num_measures % 4 != 0,
    )
    info.update(overrides)
    return info


def build_corpus(out_dir, n: int = 600, val_frac: float = 0.1) -> dict:
    """Write ``n`` seeded clips' meta and event tokens to ``out_dir`` in the
    npy layout, the first ``max(1, int(n * val_frac))`` as the val split;
    returns the counts printed by the CLI."""
    rng = random.Random(SEED)
    encoder = EventSequenceEncoder()
    parser = MetaParser()
    inputs, targets = [], []
    with tempfile.TemporaryDirectory() as td:
        for i in range(n):
            measures = rng.choice([4, 4, 8, 8, 8, 16])
            npb = max(4, min(40, int(rng.lognormvariate(3.0, 0.45))))
            bpm = rng.choice(range(40, 200, 10))
            key = rng.randrange(12)
            path = os.path.join(td, f"s{i}.mid")
            write_melody(path, bpm=bpm, num_measures=measures, seed=i,
                         key_number=key, notes_per_bar=npb)
            info = sample_info(num_measures=measures, seed=i, bpm=bpm)
            inputs.append(np.asarray(encode_meta(parser.parse(info)),
                                     dtype=np.int64))
            targets.append(np.asarray(encoder.encode(path, sample_info=info),
                                      dtype=np.int64))

    n_val = max(1, int(n * val_frac))
    os.makedirs(out_dir, exist_ok=True)

    def dump(name, arrs):
        obj = np.empty(len(arrs), dtype=object)
        for j, a in enumerate(arrs):
            obj[j] = a
        np.save(os.path.join(out_dir, name), obj, allow_pickle=True)

    dump("input_train.npy", inputs[n_val:])
    dump("target_train.npy", targets[n_val:])
    dump("input_val.npy", inputs[:n_val])
    dump("target_val.npy", targets[:n_val])
    return {"train": n - n_val, "val": n_val,
            "tokens": sum(len(t) for t in targets),
            "median_len": int(np.median([len(t) for t in targets]))}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--n", type=int, default=600)
    ap.add_argument("--val_frac", type=float, default=0.1)
    args = ap.parse_args(argv)
    counts = build_corpus(args.out_dir, args.n, args.val_frac)
    print(f"wrote {args.out_dir}: {counts['train']} train / {counts['val']} "
          f"val samples, {counts['tokens']} event tokens, median len "
          f"{counts['median_len']}")


if __name__ == "__main__":
    main()
