"""The port's own copies of the JAX-free modules and functions against their
originals.

``commu_tpu_torch`` imports nothing of ``commu_tpu``; it keeps copies of
``config``, ``vocab``, ``utils`` (constants, containers, exceptions,
logging, chords, midi_meta_utils), ``midi`` (its native parser's source
byte for byte, built at first use), ``preprocess`` (event_codec,
meta_parser, augment, preprocessor, pipeline) and ``data``. Each copy must
go on meaning what its original means: the same constants and token tables,
the same metadata tokens, the same MIDI bytes and event tokens, the same
batches, the same default configs, the same chord table and metadata
readings, and the host sampler's ``sample_from_logits`` (a function of
``commu_tpu``'s ``generation/host_sampler.py``, which imports jax) the same
tokens, probabilities and in-place tempered logits, and
``parallel.multihost``'s ``process_batch_slice`` (``commu_tpu``'s imports
jax) the same rows and the same refusal. The preprocess pipeline's outputs
are held against the original's in ``test_torch_preprocess.py``.
"""
import dataclasses
import random
import types
from pathlib import Path

import numpy as np
import pytest

import commu_tpu.config as jconfig
import commu_tpu.generation.host_sampler as jhost
import commu_tpu.data.dataset as jdata
import commu_tpu.midi as jmidi
import commu_tpu.parallel.multihost as jmultihost
import commu_tpu.preprocess.augment as jaugment
import commu_tpu.preprocess.event_codec as jcodec
import commu_tpu.preprocess.meta_parser as jparser
import commu_tpu.preprocess.pipeline as jpipeline
import commu_tpu.preprocess.preprocessor as jpreprocessor
import commu_tpu.utils.chords as jchords
import commu_tpu.utils.midi_meta_utils as jmmu
import commu_tpu.utils.constants as jconst
import commu_tpu.utils.containers as jcont
import commu_tpu.utils.exceptions as jexc
import commu_tpu.vocab.event_tokens as jtok
import commu_tpu.vocab.meta_codec as jmeta
import commu_tpu_torch.config as tconfig
import commu_tpu_torch.generation.host_sampler as thost
import commu_tpu_torch.data.dataset as tdata
import commu_tpu_torch.midi as tmidi
import commu_tpu_torch.parallel.multihost as tmultihost
import commu_tpu_torch.preprocess.augment as taugment
import commu_tpu_torch.preprocess.event_codec as tcodec
import commu_tpu_torch.preprocess.meta_parser as tparser
import commu_tpu_torch.preprocess.pipeline as tpipeline
import commu_tpu_torch.preprocess.preprocessor as tpreprocessor
import commu_tpu_torch.utils.chords as tchords
import commu_tpu_torch.utils.midi_meta_utils as tmmu
import commu_tpu_torch.utils.constants as tconst
import commu_tpu_torch.utils.containers as tcont
import commu_tpu_torch.utils.exceptions as texc
import commu_tpu_torch.vocab.event_tokens as ttok
import commu_tpu_torch.vocab.meta_codec as tmeta

from helpers import make_sample_info


def _public_values(module):
    """name -> value of a module's public data (no functions, classes or
    modules)."""
    return {name: value for name, value in vars(module).items()
            if not name.startswith("__")
            and not isinstance(value, (types.ModuleType, types.FunctionType,
                                       type))
            and not name == "annotations"}


@pytest.mark.parametrize("ours,theirs", [
    (tconst, jconst), (ttok, jtok), (tchords, jchords)],
    ids=["constants", "event_tokens", "chords"])
def test_constants_and_token_tables_are_equal(ours, theirs):
    a, b = _public_values(ours), _public_values(theirs)
    assert set(a) == set(b)
    for name, value in b.items():
        assert a[name] == value, name
    if ours is ttok:
        assert ttok.VOCAB_SIZE == jtok.VOCAB_SIZE == 729
        assert {m.name: m.value for m in ttok.TokenOffset} == {
            m.name: m.value for m in jtok.TokenOffset}
        for word in range(ttok.VOCAB_SIZE):
            assert ttok.word2event.get(word) == jtok.word2event.get(word)
        assert ttok.event2word == jtok.event2word


def test_containers_and_exceptions_are_equal():
    assert tcont.META_FIELD_ORDER == jcont.META_FIELD_ORDER
    for name in ("MidiMeta", "MidiInfo"):
        assert [(f.name, f.type) for f in dataclasses.fields(
            getattr(tcont, name))] == [(f.name, f.type) for f in
                                       dataclasses.fields(getattr(jcont, name))]
    assert {m.name: m.value for m in texc.ErrorMessage} == {
        m.name: m.value for m in jexc.ErrorMessage}
    assert issubclass(texc.UnprocessableMidiError, texc.CommuError)


def _seeded_metas(n, seed=0):
    rng = random.Random(seed)
    for _ in range(n):
        lo = rng.randrange(1, 100)
        yield dict(
            bpm=rng.choice([rng.randrange(30, 220), "unknown"]),
            audio_key=rng.choice(sorted(jconst.KEY_MAP)),
            time_signature=rng.choice(sorted(jconst.TIME_SIG_MAP)),
            pitch_range=rng.choice(sorted(jconst.PITCH_RANGE_MAP)),
            num_measures=rng.choice([4.0, 5.5, 8.0, 9.0, 16.0, 17.25]),
            inst=rng.choice(sorted(jconst.INST_MAP)),
            genre=rng.choice(sorted(jconst.GENRE_MAP)),
            min_velocity=lo, max_velocity=rng.randrange(lo, 128),
            track_role=rng.choice(sorted(jconst.TRACK_ROLE_MAP)),
            rhythm=rng.choice(sorted(jconst.RHYTHM_MAP)))


def test_encode_meta_is_equal_on_seeded_metadata():
    for bad in (29.0, "unknown"):
        fields = dict(next(_seeded_metas(1)), num_measures=bad)
        with pytest.raises(texc.UnprocessableMidiError):
            tmeta.encode_meta(tcont.MidiMeta(**fields))
        with pytest.raises(jexc.UnprocessableMidiError):
            jmeta.encode_meta(jcont.MidiMeta(**fields))
    for fields in _seeded_metas(200):
        ours = tmeta.encode_meta(tcont.MidiMeta(**fields))
        theirs = jmeta.encode_meta(jcont.MidiMeta(**fields))
        assert ours == theirs, fields
        for field, token in zip(jcont.META_FIELD_ORDER, theirs):
            assert tmeta.decode_meta_value(field, token) == \
                jmeta.decode_meta_value(field, token)


def _seeded_midi(mod, seed, num_measures=4, tpb=480):
    rng = random.Random(seed)
    midi = mod.MidiFile(ticks_per_beat=tpb)
    midi.tempo_changes = [mod.TempoChange(tempo=float(rng.randrange(60, 160)),
                                          time=0)]
    midi.time_signature_changes = [mod.TimeSignature(4, 4, 0)]
    midi.key_signature_changes = [mod.KeySignature(
        key_number=rng.randrange(24))]
    midi.markers = [mod.Marker(text="Am", time=0),
                    mod.Marker(text="F", time=tpb * 4)]
    inst = mod.Instrument(program=rng.randrange(100), name="melody")
    bar = tpb * 4
    for k in range(num_measures * 6):
        start = rng.randrange(0, num_measures * bar - tpb)
        inst.notes.append(mod.Note(
            velocity=rng.randrange(30, 120), pitch=rng.randrange(40, 90),
            start=start, end=start + rng.randrange(30, tpb * 2)))
    midi.instruments = [inst]
    return midi


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_midi_written_parsed_and_tokenised_alike(seed, tmp_path, monkeypatch):
    """The same seeded file: equal bytes out of both writers, equal objects
    out of both parsers (the original pinned to its Python parser, which is
    what the copy keeps), equal event tokens, and equal bytes again after a
    decode of those tokens."""
    monkeypatch.setenv("COMMU_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(jmidi.smf, "_NATIVE_LIB", None)
    ours_path, theirs_path = tmp_path / "ours.mid", tmp_path / "theirs.mid"
    _seeded_midi(tmidi, seed).dump(ours_path)
    _seeded_midi(jmidi, seed).dump(theirs_path)
    blob = theirs_path.read_bytes()
    assert ours_path.read_bytes() == blob and len(blob) > 100

    ours, theirs = tmidi.MidiFile(ours_path), jmidi.MidiFile(theirs_path)
    assert ours.ticks_per_beat == theirs.ticks_per_beat
    for attr in ("tempo_changes", "time_signature_changes",
                 "key_signature_changes", "markers", "instruments"):
        assert [dataclasses.asdict(x) for x in getattr(ours, attr)] == \
            [dataclasses.asdict(x) for x in getattr(theirs, attr)], attr

    info = make_sample_info(num_measures=4, seed=seed)
    tokens = tcodec.encode_midi_to_tokens(ours_path, info)
    ref = jcodec.encode_midi_to_tokens(theirs_path, info)
    np.testing.assert_array_equal(tokens, ref)
    assert tokens[-1] == ttok.EOS_ID and len(tokens) > 50

    meta = next(_seeded_metas(1, seed))
    meta.update(bpm=90, audio_key="cmajor", time_signature="4/4")
    events = [int(t) for t in ref[:-1]]
    back_ours = tcodec.decode_tokens_to_midi(tcont.MidiInfo(
        *tmeta.encode_meta(tcont.MidiMeta(**meta)), event_seq=events))
    back_theirs = jcodec.decode_tokens_to_midi(jcont.MidiInfo(
        *jmeta.encode_meta(jcont.MidiMeta(**meta)), event_seq=events))
    back_ours.dump(tmp_path / "back_ours.mid")
    back_theirs.dump(tmp_path / "back_theirs.mid")
    assert (tmp_path / "back_ours.mid").read_bytes() == \
        (tmp_path / "back_theirs.mid").read_bytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_midi_parsed_alike_on_both_native_parsers(seed, tmp_path,
                                                  monkeypatch):
    """The same seeded file through each package's native parser (the
    original's committed library, the copy's built at first use): equal
    objects and equal event tokens."""
    monkeypatch.delenv("COMMU_TPU_NO_NATIVE", raising=False)
    monkeypatch.setattr(jmidi.smf, "_NATIVE_LIB", None)
    monkeypatch.setattr(tmidi.smf, "_NATIVE_LIB", None)
    if jmidi.smf._load_native() is None:
        pytest.skip("the original's native library is not built")
    assert tmidi.smf._load_native() is not None
    path = tmp_path / "clip.mid"
    _seeded_midi(tmidi, seed).dump(path)
    ours, theirs = tmidi.MidiFile(path), jmidi.MidiFile(path)
    assert ours.ticks_per_beat == theirs.ticks_per_beat
    for attr in ("tempo_changes", "time_signature_changes",
                 "key_signature_changes", "markers", "instruments"):
        assert [dataclasses.asdict(x) for x in getattr(ours, attr)] == \
            [dataclasses.asdict(x) for x in getattr(theirs, attr)], attr
    info = make_sample_info(num_measures=4, seed=seed)
    np.testing.assert_array_equal(tcodec.encode_midi_to_tokens(path, info),
                                  jcodec.encode_midi_to_tokens(path, info))


def test_the_copy_has_no_native_parser():
    """No parser binary is committed in the copy: its source is the
    original's, byte for byte, and ``_native_build`` compiles it at first
    use into the package's ``_build/`` (which git ignores)."""
    from commu_tpu_torch.midi import _native_build

    ours = _native_build.SOURCE
    theirs = Path(jmidi.smf.__file__).parent / "native" / "smf_native.cpp"
    assert ours.read_bytes() == theirs.read_bytes()
    assert not list(ours.parent.glob("*.so"))
    assert _native_build.library_path().parent == \
        Path(tmidi.__file__).resolve().parent.parent / "_build"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    rng = np.random.RandomState(3)

    def seqs(n):
        metas = [rng.randint(560, 729, size=11).astype(np.int64)
                 for _ in range(n)]
        events = [rng.randint(2, 560, size=rng.randint(20, 120))
                  .astype(np.int64) for _ in range(n)]
        return metas, events

    d = tmp_path_factory.mktemp("corpus")
    # each side writes its own files with its own writer, from the same data
    train, val = seqs(14), seqs(6)
    for mod, name in ((tdata, "ours"), (jdata, "theirs")):
        mod.save_corpus(d / name, "train", *train)
        mod.save_corpus(d / name, "val", *val)
    return d


def _assert_batches_equal(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        for field in ("inputs", "targets", "reset"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
        assert a.token_count == b.token_count


def test_dataset_iterators_yield_equal_batches(corpus):
    for split in ("train", "val"):
        for kind in ("input", "target"):
            name = f"{kind}_{split}.npy"
            assert (corpus / "ours" / name).read_bytes() == \
                (corpus / "theirs" / name).read_bytes(), name
    ours = tdata.ComMUDataset(str(corpus / "ours"))
    theirs = jdata.ComMUDataset(str(corpus / "theirs"))
    for split in ("train", "valid", "test"):
        assert ours.num_tokens(split) == theirs.num_tokens(split)
    import itertools

    for shuffle, seed in ((True, 5), (True, 6), (False, 0)):
        _assert_batches_equal(
            itertools.islice(ours.train_iterator(4, 16, shuffle=shuffle,
                                                 seed=seed), 12),
            itertools.islice(theirs.train_iterator(4, 16, shuffle=shuffle,
                                                   seed=seed), 12))
    for split in ("valid", "test"):
        _assert_batches_equal(ours.eval_iterator(3, 16, split=split),
                              theirs.eval_iterator(3, 16, split=split))


@pytest.mark.parametrize("name", ["ModelConfig", "TrainConfig",
                                  "InitializerConfig", "EvaluateConfig",
                                  "TrainingConfig", "InferenceConfig"])
def test_default_configs_are_equal_field_by_field(name):
    ours, theirs = getattr(tconfig, name)(), getattr(jconfig, name)()
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    if name == "ModelConfig":
        assert ours.dropout == ours.attention_dropout == 0.1
    if name == "TrainingConfig":
        assert tconfig.get_default_cfg_training().to_yaml() == \
            jconfig.get_default_cfg_training().to_yaml()
        assert dataclasses.asdict(tconfig.get_default_cfg_inference()) == \
            dataclasses.asdict(jconfig.get_default_cfg_inference())


def test_config_snapshot_round_trips_through_both(tmp_path):
    cfg = tconfig.TrainingConfig(
        model=tconfig.ModelConfig(num_layers=2, dropout=0.25, same_length=True),
        train=tconfig.TrainConfig(batch_size=8, lr=0.001))
    path = tmp_path / "config.yml"
    path.write_text(cfg.to_yaml())
    assert tconfig.load_config_snapshot(path) == cfg
    assert dataclasses.asdict(jconfig.load_config_snapshot(path)) == \
        dataclasses.asdict(cfg)


def test_preprocess_copies_keep_their_interfaces():
    """The same public functions and classes under the same names, with the
    same parameters and defaults, and the same on-disk constants."""
    import inspect

    for ours, theirs in ((taugment, jaugment), (tpreprocessor, jpreprocessor),
                         (tpipeline, jpipeline), (tparser, jparser),
                         (tchords, jchords), (tmmu, jmmu)):
        def api(module):
            return {name: str(inspect.signature(value))
                    for name, value in vars(module).items()
                    if not name.startswith("_") and callable(value)
                    and getattr(value, "__module__", None) == module.__name__}
        assert api(ours) == api(theirs), ours.__name__
    for ours, theirs in ((tpreprocessor, jpreprocessor),
                         (taugment, jaugment)):
        assert ours.MIDI_EXTENSIONS == theirs.MIDI_EXTENSIONS
    assert tparser._INST_NUMBER_RE.pattern == jparser._INST_NUMBER_RE.pattern
    assert tchords.CHORD_TO_SYMBOL["ab"] == 11 and \
        tchords.SYMBOL_TO_CHORD[11] == "ab"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_midi_meta_utils_and_meta_parser_read_alike(seed, tmp_path,
                                                    monkeypatch):
    monkeypatch.setattr(jmidi.smf, "_NATIVE_LIB", False)
    path = tmp_path / "clip.mid"
    midi = _seeded_midi(tmidi, seed)
    chord = tmidi.Instrument(program=0, name="chord")
    chord.notes = [tmidi.Note(velocity=7, pitch=60, start=0, end=480)]
    midi.instruments.append(chord)
    midi.instruments[0].notes[0].velocity = 1  # a keyswitch
    midi.dump(path)
    for keyswitch in (None, 1):
        assert tmmu.get_velocity_range(path, keyswitch) == \
            jmmu.get_velocity_range(path, keyswitch)
    assert tmmu.get_time_signature(path) == jmmu.get_time_signature(path)
    empty = tmp_path / "empty.mid"
    tmidi.MidiFile(ticks_per_beat=480).dump(empty)
    assert tmmu.get_velocity_range(empty) == jmmu.get_velocity_range(empty) \
        == (tconst.UNKNOWN, tconst.UNKNOWN)

    for fields in _seeded_metas(20, seed):
        record = dict(fields, inst=f"{fields['inst']}-{seed + 1}", id="x",
                      chord_progressions=[["C"]])
        assert dataclasses.asdict(tparser.MetaParser().parse(record)) == \
            dataclasses.asdict(jparser.MetaParser().parse(record))
        assert tparser.remove_number_from_inst(record["inst"]) == \
            fields["inst"]


@pytest.mark.parametrize("return_probs", [False, True])
@pytest.mark.parametrize("temperature,top_k", [(0.95, 32), (0.0, 32),
                                               (1.3, 5), (0.5, 728)])
def test_sample_from_logits_is_equal_on_the_stale_logit_path(
        return_probs, temperature, top_k):
    """Draw, ban, then reuse the same logits (tempered again in place) under
    a longer ban list, as a banned chord token makes the loop do; both
    sides from equal numpy generators.  At temperature 0 the ban empties
    the candidates: both raise."""
    rng = np.random.default_rng(int(temperature * 10) + top_k)
    base = (rng.normal(size=728) * 3).astype(np.float32)
    ours_logits, ref_logits = base.copy(), base.copy()
    ours_rng, ref_rng = (np.random.default_rng(5), np.random.default_rng(5))
    banned = []
    for _ in range(4):
        try:
            ref = jhost.sample_from_logits(ref_logits, temperature, top_k,
                                           banned, ref_rng, return_probs)
        except jhost.SamplingError:
            with pytest.raises(thost.SamplingError, match="all candidate"):
                thost.sample_from_logits(ours_logits, temperature, top_k,
                                         banned, ours_rng, return_probs)
            assert temperature == 0.0 and banned
            break
        ours = thost.sample_from_logits(ours_logits, temperature, top_k,
                                        banned, ours_rng, return_probs)
        if return_probs:
            assert ours[0] == ref[0]
            np.testing.assert_array_equal(ours[1], ref[1])
            token = ours[0]
        else:
            assert ours == ref
            token = ours
        np.testing.assert_array_equal(ours_logits, ref_logits)
        banned.append(token)


def test_process_batch_slice_is_the_original_s():
    """The same rows for every process of every world that divides the
    batch, the same default for one process, the same refusal."""
    import inspect

    assert str(inspect.signature(tmultihost.process_batch_slice)) == \
        str(inspect.signature(jmultihost.process_batch_slice))
    for batch in (1, 8, 12, 256):
        for count in (1, 2, 3, 4, 8):
            if batch % count:
                for module in (tmultihost, jmultihost):
                    with pytest.raises(ValueError, match="not divisible"):
                        module.process_batch_slice(batch, 0, count)
                continue
            for index in range(count):
                assert tmultihost.process_batch_slice(batch, index, count) \
                    == jmultihost.process_batch_slice(batch, index, count)
    assert tmultihost.process_batch_slice(8) == \
        jmultihost.process_batch_slice(8)


@pytest.mark.parametrize("seed,measures,npb,key", [(0, 4, 4, 0), (1, 8, 13, 7),
                                                   (5, 16, 40, 11)])
def test_synthetic_clips_and_records_are_the_helpers(seed, measures, npb,
                                                     key, tmp_path):
    """``data.synthetic``'s melody writer and metadata record against
    ``tests/helpers.py``'s ``make_commu_midi`` and ``make_sample_info``,
    which ``scripts/make_synthetic_corpus.py`` draws its corpus with: the
    same MIDI bytes and the same record."""
    from helpers import make_commu_midi
    from commu_tpu_torch.data import synthetic

    ours, theirs = tmp_path / "ours.mid", tmp_path / "theirs.mid"
    synthetic.write_melody(str(ours), bpm=130, num_measures=measures,
                           seed=seed, key_number=key, notes_per_bar=npb)
    make_commu_midi(str(theirs), bpm=130, num_measures=measures, seed=seed,
                    key_number=key, notes_per_bar=npb)
    assert ours.read_bytes() == theirs.read_bytes()
    assert synthetic.CHORD_POOL == __import__("helpers").CHORD_POOL
    assert (synthetic.sample_info(num_measures=measures, seed=seed, bpm=130)
            == make_sample_info(num_measures=measures, seed=seed, bpm=130))


def test_synthetic_corpus_equals_the_scripts(tmp_path):
    """``python -m commu_tpu_torch.data.synthetic OUT --n 6`` and
    ``scripts/make_synthetic_corpus.py OUT --n 6`` (seed 1111, val_frac
    0.1), each in its own interpreter: the same four npy files, array by
    array and element by element, and the port's run loads no JAX module."""
    import os
    import subprocess
    import sys

    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    code = ("import runpy, sys\n"
            "sys.argv = ['synthetic', sys.argv[1], '--n', '6']\n"
            "runpy.run_module('commu_tpu_torch.data.synthetic', "
            "run_name='__main__')\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'commu_tpu')))\n")
    ours = subprocess.run([sys.executable, "-c", code, str(tmp_path / "ours")],
                          capture_output=True, text=True, cwd=root, env=env,
                          timeout=120)
    assert ours.returncode == 0, ours.stderr[-2000:]
    assert ours.stdout.splitlines()[-1] == "[]"
    theirs = subprocess.run(
        [sys.executable, str(root / "scripts" / "make_synthetic_corpus.py"),
         str(tmp_path / "theirs"), "--n", "6"], capture_output=True,
        text=True, cwd=root, env=env, timeout=120)
    assert theirs.returncode == 0, theirs.stderr[-2000:]
    assert ours.stdout.splitlines()[0] == theirs.stdout.splitlines()[-1].replace(
        str(tmp_path / "theirs"), str(tmp_path / "ours"))
    for split, count in (("train", 5), ("val", 1)):
        for kind in ("input", "target"):
            name = f"{kind}_{split}.npy"
            a = np.load(tmp_path / "ours" / name, allow_pickle=True)
            b = np.load(tmp_path / "theirs" / name, allow_pickle=True)
            assert a.dtype == b.dtype == object and len(a) == len(b) == count
            for x, y in zip(a, b):
                assert x.dtype == y.dtype == np.int64
                np.testing.assert_array_equal(x, y)
