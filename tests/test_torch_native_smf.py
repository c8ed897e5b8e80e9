"""The port's native (C++) MIDI parser: built at first use from its copy of
the source, the same objects as its own Python parser and as the JAX
package's parser, the same event tokens, and safe to build from several
processes at once.  Runs here: it needs ``g++``, not a card."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import commu_tpu.midi.smf as jsmf
import commu_tpu_torch.midi.smf as tsmf
from commu_tpu_torch.midi import _native_build
from commu_tpu_torch.midi.smf import MidiFile
from helpers import make_commu_midi, make_sample_info

REPO_ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def native(monkeypatch):
    """The port's library, loaded afresh with the variable unset."""
    monkeypatch.delenv("COMMU_TPU_NO_NATIVE", raising=False)
    monkeypatch.setattr(tsmf, "_NATIVE_LIB", None)
    lib = tsmf._load_native()
    assert lib is not None
    return lib


def _parse_both(lib, blob):
    ours_native = MidiFile(ticks_per_beat=0)
    ours_native._parse_native(lib, blob)
    ours_python = MidiFile(ticks_per_beat=0)
    ours_python._parse_python(blob)
    return ours_native, ours_python


def _fields(midi):
    """Every parsed field as plain values, for comparisons across the two
    packages' classes."""
    return (midi.ticks_per_beat,
            [(i.program, i.is_drum, i.name,
              [(n.velocity, n.pitch, n.start, n.end) for n in i.notes])
             for i in midi.instruments],
            [(t.tempo, t.time) for t in midi.tempo_changes],
            [(t.numerator, t.denominator, t.time)
             for t in midi.time_signature_changes],
            [(k.key_number, k.time) for k in midi.key_signature_changes],
            [(m.text, m.time) for m in midi.markers])


def _rich_midi(mod):
    """Two instruments, overlapping notes of one pitch (FIFO matching), a
    tempo map, two meters, two keys, markers (``tests/test_native_smf.py``'s
    rich file)."""
    m = mod.MidiFile(ticks_per_beat=960)
    m.tempo_changes = [mod.TempoChange(120.0, 0), mod.TempoChange(90.0, 1920),
                       mod.TempoChange(140.0, 5000)]
    m.time_signature_changes = [mod.TimeSignature(6, 8, 0),
                                mod.TimeSignature(4, 4, 3840)]
    m.key_signature_changes = [mod.KeySignature(key_number=15, time=0),
                               mod.KeySignature(key_number=4, time=1920)]
    m.markers = [mod.Marker("Am", 0), mod.Marker("F(add2)", 960)]
    melody = mod.Instrument(program=5, name="melody")
    melody.notes = [mod.Note(80, 60, 0, 500), mod.Note(70, 60, 100, 900),
                    mod.Note(90, 72, 100, 400), mod.Note(60, 60, 600, 1000)]
    chords = mod.Instrument(program=0, name="chord")
    chords.notes = [mod.Note(64, 48, 0, 1900), mod.Note(64, 52, 0, 1900)]
    m.instruments = [melody, chords]
    return m


def _files(tmp_path):
    simple = tmp_path / "simple.mid"
    make_commu_midi(simple, bpm=70, num_measures=4, key_number=21, seed=3)
    rich = tmp_path / "rich.mid"
    _rich_midi(tsmf).dump(rich)
    assert rich.read_bytes() == _dump(_rich_midi(jsmf), tmp_path / "j.mid")
    return {"simple": simple, "rich": rich}


def _dump(midi, path):
    midi.dump(path)
    return path.read_bytes()


@pytest.mark.parametrize("name", ["simple", "rich"])
def test_native_parses_as_the_python_parser_and_the_original(native, tmp_path,
                                                             name):
    blob = _files(tmp_path)[name].read_bytes()
    ours_native, ours_python = _parse_both(native, blob)
    theirs_python = jsmf.MidiFile(ticks_per_beat=0)
    theirs_python._parse_python(blob)
    assert _fields(ours_native) == _fields(ours_python) == \
        _fields(theirs_python)
    if name == "rich":  # the FIFO matching of one pitch's overlapping notes
        assert [(n.pitch, n.start, n.end)
                for n in ours_native.instruments[0].notes] == \
            [(60, 0, 500), (60, 100, 900), (72, 100, 400), (60, 600, 1000)]
    theirs_lib = jsmf._load_native()
    if theirs_lib is not None:  # the original's committed library
        theirs_native = jsmf.MidiFile(ticks_per_beat=0)
        theirs_native._parse_native(theirs_lib, blob)
        assert _fields(theirs_native) == _fields(ours_native)


def test_native_refuses_what_the_python_parser_refuses(native):
    for blob in (b"nonsense", b"MThd" + b"\x00" * 10 + b"junkjunk"):
        native_err = python_err = None
        try:
            MidiFile(ticks_per_beat=0)._parse_native(native, blob)
        except ValueError as e:
            native_err = str(e)
        try:
            MidiFile(ticks_per_beat=0)._parse_python(blob)
        except ValueError as e:
            python_err = str(e)
        except Exception:
            python_err = "corrupt"
        assert (native_err is None) == (python_err is None)


def test_native_is_the_default_and_the_variable_selects_python(
        native, tmp_path, monkeypatch):
    path = _files(tmp_path)["rich"]
    calls = []
    for method in ("_parse_native", "_parse_python"):
        orig = getattr(MidiFile, method)

        def spy(self, *args, _orig=orig, _name=method):
            calls.append(_name)
            return _orig(self, *args)
        monkeypatch.setattr(MidiFile, method, spy)
    default = MidiFile(path)
    monkeypatch.setenv("COMMU_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(tsmf, "_NATIVE_LIB", None)
    python = MidiFile(path)
    assert calls == ["_parse_native", "_parse_python"]
    assert _fields(default) == _fields(python)
    assert Path(native._name) == _native_build.library_path()


def test_codec_tokens_over_either_parser(native, tmp_path, monkeypatch):
    from commu_tpu_torch.preprocess.event_codec import encode_midi_to_tokens

    path = tmp_path / "d.mid"
    make_commu_midi(path, seed=7)
    info = make_sample_info(seed=7)
    info["is_incomplete_measure"] = False
    tokens_native = encode_midi_to_tokens(str(path), info)
    python_midi = MidiFile(ticks_per_beat=0)
    python_midi._parse_python(path.read_bytes())
    tokens_python = encode_midi_to_tokens(python_midi, info)
    np.testing.assert_array_equal(tokens_native, tokens_python)
    assert len(tokens_native) > 20


def test_two_processes_build_the_library_at_once(tmp_path, monkeypatch):
    """Two fresh interpreters build into an empty directory at the same
    time: both load a whole library and parse the same file alike, and the
    directory holds the one library and no temporary or log file."""
    build_dir = tmp_path / "build"
    path = tmp_path / "clip.mid"
    make_commu_midi(path, seed=5)
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from commu_tpu_torch.midi import _native_build, smf\n"
        f"_native_build.BUILD_DIR = Path({str(build_dir)!r})\n"
        f"midi = smf.MidiFile({str(path)!r})\n"
        "assert smf._NATIVE_LIB and 'torch' not in sys.modules\n"
        "print(sum(len(i.notes) for i in midi.instruments),"
        " smf._NATIVE_LIB._name)\n")
    env = {k: v for k, v in os.environ.items() if k != "COMMU_TPU_NO_NATIVE"}
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO_ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    lines = {out.split()[0] for out, _ in outs}
    libs = {Path(out.split()[1]) for out, _ in outs}
    assert len(lines) == 1 and int(lines.pop()) > 0
    assert libs == {build_dir / _native_build.library_path().name}
    assert sorted(p.name for p in build_dir.iterdir()) == \
        [_native_build.library_path().name]


def test_a_failed_build_names_the_compilers_log(tmp_path, monkeypatch):
    monkeypatch.setattr(_native_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_native_build, "CXX_FLAGS",
                        _native_build.CXX_FLAGS + ["-no-such-flag"])
    with pytest.raises(RuntimeError, match=r"the compiler's log: .*\.log"):
        _native_build.build()
    logs = list(tmp_path.glob("*.log"))
    assert len(logs) == 1 and "no-such-flag" in logs[0].read_text()
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))
