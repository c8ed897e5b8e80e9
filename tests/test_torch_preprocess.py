"""The port's preprocess pipeline against the JAX package's, on the CPU.

``commu_tpu_torch.preprocess`` and ``commu_tpu_torch.utils.{chords,
midi_meta_utils}`` are copies of their ``commu_tpu`` originals, but for the
metadata CSV, which the port reads with ``csv`` where the original calls
``pandas.read_csv``.  On the same seeded inputs both packages must give the
same transposed chords, the same augmented ``.mid`` bytes, the same CSV
records (values and their types) and the same ``output_npy`` arrays, element
by element and dtype for dtype, at ``num_cores`` 1 and 2.  The CLI runs
without torch, pandas or JAX, and the chain preprocess -> train -> generate
runs end to end on the CPU.  The raw corpus is ``chip_smoke.py``'s
``write_raw_corpus``, the one its corpus-chain phase preprocesses on the
card, at fewer clips.
"""
import io
import json
import math
import random
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from commu_tpu.preprocess import augment as jaugment
from commu_tpu.preprocess import preprocessor as jpreprocessor
from commu_tpu.preprocess.pipeline import PreprocessPipeline as JPipeline
from commu_tpu.utils.chords import sync_key_augment as jsync
from commu_tpu.utils.constants import KEY_NUM_MAP
from commu_tpu_torch.preprocess import augment as taugment
from commu_tpu_torch.preprocess import preprocessor as tpreprocessor
from commu_tpu_torch.preprocess.pipeline import PreprocessPipeline as TPipeline
from commu_tpu_torch.utils import sync_key_augment as tsync
from conftest import REPO_ROOT
from helpers import make_commu_midi

# every key root that augmentation writes into a file name, as the
# preprocessor hands it to sync_key_augment
AUGMENTED_ROOTS = sorted({name.replace("minor", "").replace("major", "")
                          for name in KEY_NUM_MAP.values()})
CHORDS = ["C", "C#", "Db", "D", "D#", "Eb", "E", "F", "F#", "Gb", "G", "G#",
          "Ab", "A", "A#", "Bb", "B"]
QUALITIES = ["", "m", "7", "maj7", "m7", "dim", "sus4", "m7b5", "/E", "(9)"]


@pytest.mark.parametrize("origin", ["c", "a"])
def test_sync_key_augment_matches(origin):
    rng = random.Random(15)
    progressions = [[rng.choice(CHORDS) + rng.choice(QUALITIES)
                     for _ in range(rng.randrange(1, 33))] for _ in range(20)]
    progressions.append([c + q for c in CHORDS for q in QUALITIES])
    for chords in progressions:
        for aug in AUGMENTED_ROOTS:
            ours = tsync(chords, aug, origin)
            assert ours == jsync(chords, aug, origin), (chords, aug)
            assert len(ours) == 1 and len(ours[0]) == len(chords)


def _clip(path, case):
    """A seeded clip for each augmentation case."""
    key_number = {"cmajor": 0, "aminor_wraps": 21, "high_pitch": 0,
                  "low_pitch_ebminor": 15, "two_tempos": 9}[case]
    midi = make_commu_midi(path, bpm=73, num_measures=4,
                           key_number=key_number, seed=len(case))
    if case == "high_pitch":
        midi.instruments[0].notes[0].pitch = 126  # +2 .. +5 leave the range
    elif case == "low_pitch_ebminor":
        midi.instruments[0].notes[3].pitch = 3    # -4 .. -6 leave the range
    elif case == "two_tempos":
        tempo = type(midi.tempo_changes[0])
        midi.tempo_changes = [tempo(tempo=70.0, time=0),
                              tempo(tempo=100.0, time=480 * 8)]
    midi.dump(path)


@pytest.mark.parametrize("case", ["cmajor", "aminor_wraps", "high_pitch",
                                  "low_pitch_ebminor", "two_tempos"])
def test_augment_writes_the_same_bytes(tmp_path, case):
    src = tmp_path / "commu00007.mid"
    _clip(src, case)
    skipped = 0
    for shift in range(-6, 6):
        outs = {}
        for name, mod in (("ours", taugment), ("theirs", jaugment)):
            tmp_dir, out_dir = tmp_path / name / "tmp", tmp_path / name / "aug"
            tmp_dir.mkdir(parents=True, exist_ok=True)
            out_dir.mkdir(parents=True, exist_ok=True)
            outs[name] = mod.augment_by_key(str(src), str(tmp_dir), shift)
            if outs[name] is not None:
                for bpm_change in range(-2, 3):
                    mod.augment_by_bpm(outs[name], str(out_dir), bpm_change)
        ours, theirs = outs["ours"], outs["theirs"]
        assert (ours is None) == (theirs is None), shift
        if theirs is None:
            skipped += 1
            continue
        assert Path(ours).name == Path(theirs).name
        assert Path(ours).read_bytes() == Path(theirs).read_bytes()
    names = sorted(p.name for p in (tmp_path / "theirs" / "aug").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "ours" / "aug").iterdir())
    assert len(names) == 5 * (12 - skipped)
    for name in names:
        assert (tmp_path / "ours" / "aug" / name).read_bytes() == \
            (tmp_path / "theirs" / "aug" / name).read_bytes(), name
    assert skipped == {"high_pitch": 4, "low_pitch_ebminor": 3}.get(case, 0)
    if case == "aminor_wraps":  # (21 - 12) + 5 wraps to MINOR_KEY[2]
        assert "commu00007_dminor_73.mid" in names
    # 73 BPM stays 73 (it reads back as 72.99998: snapped, not truncated);
    # two tempos average to 82.35 by duration, floored to 80
    centre = 80 if case == "two_tempos" else 73
    assert {int(n[:-4].rsplit("_", 1)[1]) for n in names} == {
        centre + 5 * change for change in range(-2, 3)}


CSV_CASES = {
    # the reference's columns behind an unnamed index, one blank
    # min_velocity (the column turns float), a decimal num_measures and a
    # bool column
    "metadata": (
        ",audio_key,chord_progressions,num_measures,bpm,inst,min_velocity,"
        "max_velocity,is_incomplete_measure,id\n"
        "0,cmajor,\"[['C', 'F', 'G', 'C']]\",4.0,70,acoustic_piano-2,40,100,"
        "False,commu00001\n"
        "1,aminor,\"[['Am', 'Dm']]\",5.5,120,string_ensemble,,90,True,"
        "commu00002\n"
        "2,cmajor,\"[['C']]\",8.0,95,acoustic_piano,61,127,False,"
        "commu00003\n"),
    # repeated names, padded integers, inf, NA spellings, a bool column
    # with a blank, a blank column, a quoted comma, exponents, leading zeros
    "inference": (
        ",a,b,c,d,e,f,a,g,h,i,j,k,l,chord_progressions\n"
        "0,1,True,4.0,x,,True,5, 7,inf,,None,1e3,-5,\"[['C']]\"\n"
        "1,,False,8,y,,,6,8 ,-Infinity,z,NA,2,+3,\"[['F', 'G']]\"\n"
        "2,3,True,9,True,,False,7,9,1.5,\"w, v\",q,3,007,\"[[]]\"\n"),
    # blank lines skipped, a short row padded with blanks
    "ragged": (
        "id,bpm,audio_key,flag\n\n"
        "commu00009,80,cmajor,TRUE\n"
        "commu00010,81\n\n"),
}


def _assert_same_records(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert list(a) == list(b)
        for key, want in b.items():
            got = a[key]
            assert type(got) is type(want), (key, got, want)
            if isinstance(want, float) and math.isnan(want):
                assert math.isnan(got), key
            else:
                assert got == want, key


@pytest.mark.parametrize("case", sorted(CSV_CASES))
def test_read_csv_records_matches_pandas(tmp_path, case):
    path = tmp_path / "meta.csv"
    path.write_text(CSV_CASES[case])
    ours = tpreprocessor.read_csv_records(path)
    _assert_same_records(ours, jpreprocessor.read_csv_records(path))
    if case == "metadata":
        assert math.isnan(ours[1]["min_velocity"])
        assert ours[0]["min_velocity"] == 40.0
        assert "Unnamed: 0" in ours[0]
        assert ours[0]["is_incomplete_measure"] is False


def test_read_csv_records_on_the_chain_corpus(tmp_path):
    csv_path, rows, _ = chip_smoke.write_raw_corpus(tmp_path, (("train", 3),
                                                               ("val", 1)))
    ours = tpreprocessor.read_csv_records(csv_path)
    _assert_same_records(ours, jpreprocessor.read_csv_records(csv_path))
    for record, row in zip(ours, rows):
        assert {k: record[k] for k in row} == row


@pytest.fixture(scope="module")
def raw_corpus(tmp_path_factory):
    """Three train clips (a D major parent, dropped; one whose +3..+5
    transposes are skipped; an A minor one) and two val clips."""
    root = tmp_path_factory.mktemp("raw") / "dataset"
    csv_path, rows, expected = chip_smoke.write_raw_corpus(
        root, (("train", 3), ("val", 2)))
    assert expected == {"train": 60 + 45, "val": 120}
    return root, csv_path, rows, expected


def _run_pipeline(pipeline, raw_corpus, dest, num_cores):
    root, csv_path, _, _ = raw_corpus
    shutil.copytree(root, dest)
    pipeline()(root_dir=dest, csv_path=dest / csv_path.name,
               num_cores=num_cores)
    return dest


def _file_names(root, sub):
    return {split: sorted(str(p.relative_to(root / split / sub))
                          for p in (root / split / sub).rglob("*")
                          if p.is_file())
            for split in ("train", "val")}


@pytest.mark.parametrize("num_cores", [1, 2])
def test_pipeline_writes_the_same_corpus(raw_corpus, tmp_path, num_cores):
    ours = _run_pipeline(TPipeline, raw_corpus, tmp_path / "ours", num_cores)
    theirs = _run_pipeline(JPipeline, raw_corpus, tmp_path / "theirs",
                           num_cores)
    expected = raw_corpus[3]
    for sub in ("augmented", "npy_tmp"):
        assert _file_names(ours, sub) == _file_names(theirs, sub), sub
    assert len(_file_names(ours, "npy_tmp")["train"]) == 2 * expected["train"]
    for split, count in expected.items():
        for kind in ("input", "target"):
            name = f"{kind}_{split}.npy"
            a = np.load(ours / "output_npy" / name, allow_pickle=True)
            b = np.load(theirs / "output_npy" / name, allow_pickle=True)
            assert a.dtype == b.dtype == object and a.shape == b.shape
            assert len(a) == count, name
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and x.shape == y.shape
                assert [type(v) for v in x] == [type(v) for v in y]
                np.testing.assert_array_equal(x, y)
            assert b[0].dtype == (object if kind == "input" else np.int16)


def _chain_metadata(rows):
    record = next(r for r in rows if r["split_data"] == "val")
    flags = ["--chord_progression", "-".join(record["chord_progressions"][0]),
             "--rhythm", record["sample_rhythm"]]
    for key in ("bpm", "audio_key", "time_signature", "pitch_range",
                "num_measures", "inst", "genre", "min_velocity",
                "max_velocity", "track_role"):
        flags += [f"--{key}", str(record[key])]
    return flags


def test_cli_imports_no_torch_pandas_or_jax(raw_corpus, tmp_path):
    root, csv_path, _, expected = raw_corpus
    shutil.copytree(root, tmp_path / "dataset")
    code = (
        "import json, runpy, sys\n"
        f"sys.argv = ['preprocess', '--root_dir', {str(tmp_path / 'dataset')!r},"
        f" '--csv_path', {str(tmp_path / 'dataset' / csv_path.name)!r},"
        " '--num_cores', '2']\n"
        "runpy.run_module('commu_tpu_torch.preprocess', run_name='__main__',"
        " alter_sys=True)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'flax', 'commu_tpu', 'pandas', 'torch'))))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO_ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.splitlines()[-1]) == []
    assert "Finished preprocessing" in proc.stdout
    out = tmp_path / "dataset" / "output_npy"
    for split, count in expected.items():
        assert len(np.load(out / f"target_{split}.npy",
                           allow_pickle=True)) == count


def test_chain_preprocess_train_generate_on_cpu(tmp_path):
    from commu_tpu_torch import generate
    from commu_tpu_torch import train as train_cli
    from commu_tpu_torch.generation.postprocess import read_midi

    root = tmp_path / "dataset"
    csv_path, rows, expected = chip_smoke.write_raw_corpus(
        root, (("train", 2), ("val", 1)))
    proc = subprocess.run(
        [sys.executable, "-m", "commu_tpu_torch.preprocess", "--root_dir",
         str(root), "--csv_path", str(csv_path), "--num_cores", "2"],
        capture_output=True, text=True, cwd=REPO_ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]

    overrides = ["model.num_layers=2", "model.num_heads=2", "model.units=32",
                 "model.inner_size=48", "train.batch_size=4",
                 "train.batch_chunk=2", "train.tgt_length=16",
                 "train.mem_length=32", "train.warmup_step=2",
                 "train.log_interval=2", "train.eval_interval=2",
                 "evaluate.batch_size=4", "evaluate.tgt_length=64",
                 "evaluate.mem_length=64"]
    work = Path(train_cli.main(
        ["--data_dir", str(root / "output_npy"), "--work_dir",
         str(tmp_path / "runs"), "--device", "cpu", "--dtype", "float32",
         "--max_step", "2"] + [a for o in overrides for a in ("--set", o)]))
    log = (work / "train.log").read_text()
    assert "Train Step 2/2" in log and "End of training | test nll" in log
    assert f"#samples train/val/test: {expected['train']}/" \
        f"{expected['val']}/{expected['val']}" in log
    best = work / "checkpoint_best.pt"
    assert best.is_file()

    out_dir = tmp_path / "generated"
    generate.main(["--checkpoint_dir", str(best), "--output_dir", str(out_dir),
                   "--num_generate", "2", "--lenient", "--gen_length", "64",
                   "--device", "cpu", *_chain_metadata(rows)],
                  stdout=io.StringIO())
    files = sorted(out_dir.rglob("*.mid"))
    assert len(files) == 2
    for path in files:
        read_midi(path)
