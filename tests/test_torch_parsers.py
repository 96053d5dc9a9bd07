"""The port's preprocessing against the JAX package's, on the CPU: the MIDI
reader (`utils/midi_io.py:read_midi`), `Segmenter.chunk_audio_and_notes`,
the Lakh parser and the ENST, MDB and TMIDT text parsers (`data/lakh.py`,
`data/parsers.py`) on synthetic corpora built as `tests/test_parsers.py` and
`tests/test_data.py` build them. The shards must have the same names and be
byte-equal to the JAX parsers' shards; the port's datasets must read from
them the items they read from the JAX shards; the CLIs (`python -m
adt_str_tpu_torch.scripts.{midi_parser,text_parser}`) run on temporary
configs; without pyarrow, the writers raise an ImportError that names it.
"""

import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from adt_str_tpu.config import SharedConfig as JSharedConfig
from adt_str_tpu.data.lakh import LakhMidiParser as JLakhMidiParser
from adt_str_tpu.data.parsers import ENSTDrumTextParser as JENST
from adt_str_tpu.data.parsers import MDBDrumTextParser as JMDB
from adt_str_tpu.data.parsers import TextParserConfig as JTextParserConfig
from adt_str_tpu.data.parsers import TMIDTTextParser as JTMIDT
from adt_str_tpu.domain.segmenter import Segmenter as JSegmenter
from adt_str_tpu.utils.midi_io import read_midi as jread_midi
from adt_str_tpu_torch.config import EvalDataConfig, SharedConfig, TokenizerConfig, TrainDataConfig
from adt_str_tpu_torch.data import datasets as tdata
from adt_str_tpu_torch.data import parsers as tparsers
from adt_str_tpu_torch.data.lakh import LakhMidiParser
from adt_str_tpu_torch.domain.segmenter import Segmenter
from adt_str_tpu_torch.domain.tokenizer import MidiTokenizer
from adt_str_tpu_torch.utils.audio_io import write_wav
from adt_str_tpu_torch.utils.midi_io import read_midi, write_midi

REPO = Path(__file__).resolve().parent.parent
SR = 4000
FRAMING = dict(input_sec=0.64, time_res=0.01, win_length=256, sample_rate=SR)


def tone(sec: float, freq: float = 220.0) -> np.ndarray:
    t = np.arange(int(sec * SR)) / SR
    return (0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def shard_bytes(root: Path) -> dict:
    """Every parquet file under `root` by relative path -> its bytes."""
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*.parquet"))}


def instruments(insts) -> list:
    return [(i.program, i.is_drum, i.notes) for i in insts]


# ------------------------------------------------------------------ MIDI reader


@pytest.mark.parametrize("is_drum, program", [(True, 0), (False, 24)], ids=["drums", "non-drum"])
def test_read_midi_equals_jax_on_write_midi_files(tmp_path, is_drum, program):
    rng = np.random.default_rng(3)
    onsets = np.sort(rng.uniform(0, 4.0, 30))
    notes = np.stack([onsets, onsets + rng.uniform(0.01, 0.5, 30), rng.integers(35, 82, 30),
                      rng.integers(1, 128, 30)], axis=1)
    path = tmp_path / "x.mid"
    write_midi(path, notes, is_drum=is_drum, program=program)
    got, ref = read_midi(path), jread_midi(path)
    assert instruments(got) == instruments(ref)
    assert got[0].is_drum == is_drum and got[0].program == program and len(got[0].notes) == 30


def _track(events: bytes) -> bytes:
    return b"MTrk" + struct.pack(">I", len(events)) + events


def test_read_midi_equals_jax_on_a_two_track_file(tmp_path):
    """Format 1, a tempo change, running status, a program change, note-on
    velocity 0 as note-off, overlapping hits of one pitch, a zero-length hit
    and a drum and a bass channel in one track."""
    tempo = bytes([0x00, 0xFF, 0x51, 0x03, 0x07, 0xA1, 0x20, 0x83, 0x60, 0xFF, 0x51, 0x03, 0x09, 0x27, 0xC0,
                   0x00, 0xFF, 0x2F, 0x00])
    notes = bytes([
        0x00, 0xC1, 0x21,              # bass program 33 on channel 1
        0x00, 0x99, 0x24, 0x64,        # drum 36 on
        0x10, 0x26, 0x50,              # running status: drum 38 on
        0x10, 0x24, 0x40,              # drum 36 on again (overlap)
        0x20, 0x89, 0x24, 0x00,        # drum 36 off: closes both
        0x00, 0x91, 0x28, 0x70,        # bass 40 on
        0x40, 0x99, 0x26, 0x00,        # drum 38 off as velocity 0
        0x00, 0x2A, 0x30,              # drum 42 on
        0x00, 0x89, 0x2A, 0x00,        # drum 42 off at the same tick: dropped
        0x81, 0x00, 0x81, 0x28, 0x00,  # bass 40 off after a two-byte delta
        0x00, 0xFF, 0x2F, 0x00,
    ])
    path = tmp_path / "two.mid"
    path.write_bytes(b"MThd" + struct.pack(">IHHH", 6, 1, 2, 96) + _track(tempo) + _track(notes))
    got = read_midi(path)
    assert instruments(got) == instruments(jread_midi(path))
    assert sorted((i.program, i.is_drum, len(i.notes)) for i in got) == [(0, True, 3), (33, False, 1)]


def test_read_midi_refuses_what_jax_refuses(tmp_path):
    for name, raw in (("bad.mid", b"RIFF0000"), ("smpte.mid", b"MThd" + struct.pack(">IHHH", 6, 0, 1, 0xE728))):
        path = tmp_path / name
        path.write_bytes(raw)
        with pytest.raises(ValueError) as ours:
            read_midi(path)
        with pytest.raises(ValueError) as theirs:
            jread_midi(path)
        assert str(ours.value) == str(theirs.value)


# ------------------------------------------------------------------ segmenter

SEGMENT_CASES = {
    "two chunks": (5.0, [[0.1, 0.2, 38, 100], [3.0, 3.1, 42, 90]], False),
    "padded tail": (3.0, [], True),
    "ragged tail": (3.0, [[2.6, 2.7, 36, 80]], False),
    "straddling note dropped": (5.2, [[2.55, 2.65, 38, 100], [4.0, 4.1, 49, 60]], True),
    "empty audio": (0.0, [], False),
}


@pytest.mark.parametrize("case", SEGMENT_CASES, ids=list(SEGMENT_CASES))
def test_chunk_audio_and_notes_equals_jax(case):
    sec, notes, pad_tail = SEGMENT_CASES[case]
    audio = np.random.default_rng(0).normal(size=int(sec * 24000)).astype(np.float32)
    notes = np.asarray(notes, np.float32).reshape(-1, 4)
    got = Segmenter(SharedConfig(input_sec=2.56, sample_rate=24000)).chunk_audio_and_notes(audio, notes, pad_tail)
    ref = JSegmenter(JSharedConfig(input_sec=2.56, sample_rate=24000)).chunk_audio_and_notes(audio, notes, pad_tail)
    for ours, theirs in zip(got, ref):
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_chunk_audio_and_notes_raises_past_the_audio_as_jax():
    audio = np.zeros(24000, np.float32)
    notes = np.array([[5.0, 5.1, 38, 100]], np.float32)
    with pytest.raises(ValueError) as ours:
        Segmenter(SharedConfig(input_sec=2.56, sample_rate=24000)).chunk_audio_and_notes(audio, notes)
    with pytest.raises(ValueError) as theirs:
        JSegmenter(JSharedConfig(input_sec=2.56, sample_rate=24000)).chunk_audio_and_notes(audio, notes)
    assert str(ours.value) == str(theirs.value)


# ------------------------------------------------------------------ Lakh


@pytest.fixture
def lakh_tree(tmp_path):
    """An lmd_matched-style tree: partitions A and B of drum files, a
    non-drum file, and a corrupt file that both parsers skip."""
    rng = np.random.default_rng(0)
    root = tmp_path / "lmd"
    for part, name in (("A", "TRAAA123"), ("A", "TRAAB456"), ("B", "TRBAA789")):
        d = root / part / name
        d.mkdir(parents=True)
        n = 40
        onsets = np.sort(rng.uniform(0, 9.0, n))
        pitches = rng.choice([30, 36, 38, 42, 46, 49, 85], n)  # 30 and 85 are not drum pitches
        notes = np.stack([onsets, onsets + 0.1, pitches, rng.integers(40, 127, n)], axis=1)
        write_midi(d / "deadbeef.mid", notes, is_drum=True)
    write_midi(root / "A" / "TRAAA123" / "melodic.mid", np.array([[0.0, 0.5, 60, 100]]), is_drum=False)
    (root / "B" / "TRBAA789" / "broken.mid").write_bytes(b"MThd\x00\x00")
    return root


def test_lakh_dataset_reads_the_port_shards_as_jax_shards(lakh_tree, tmp_path):
    """Shard names and bytes equal the JAX parser's; the port's LakhDataset
    yields the same examples from both."""
    jout = JLakhMidiParser(str(lakh_tree), str(tmp_path / "jax"), JSharedConfig(**FRAMING),
                           partitions=["A", "B"]).create_dataset()
    out = LakhMidiParser(str(lakh_tree), str(tmp_path / "port"), SharedConfig(**FRAMING),
                         partitions=["A", "B"]).create_dataset()
    assert [Path(p).relative_to(tmp_path / "port") for p in out] == [
        Path(p).relative_to(tmp_path / "jax") for p in jout]
    assert shard_bytes(tmp_path / "port") == shard_bytes(tmp_path / "jax")
    tok = MidiTokenizer(TokenizerConfig())
    sets = []
    for side in ("port", "jax"):
        cfg = TrainDataConfig(dataset_path=str(tmp_path / side / "lakh_matched"), partitions=["A", "B"],
                              empty_tokens_percentage=0.0, max_tokens=128, **FRAMING)
        ds = tdata.LakhDataset(cfg, tok, max_notes=32)
        rng = np.random.default_rng(5)
        sets.append([ds.example(i, rng) for i in range(len(ds))])
    assert len(sets[0]) > 4
    for a, b in zip(*sets):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_lakh_process_pool_shards_equal_jax(lakh_tree, tmp_path):
    """`n_jobs = 2` (spawned workers) writes the sequential JAX parser's bytes."""
    JLakhMidiParser(str(lakh_tree), str(tmp_path / "jax"), JSharedConfig(**FRAMING), partitions=["A"]).create_dataset()
    LakhMidiParser(str(lakh_tree), str(tmp_path / "port"), SharedConfig(**FRAMING), partitions=["A"],
                   n_jobs=2).create_dataset()
    assert shard_bytes(tmp_path / "port") == shard_bytes(tmp_path / "jax")


def test_lakh_refuses_a_bad_partition(tmp_path):
    with pytest.raises(ValueError, match="A-Z"):
        LakhMidiParser(str(tmp_path), str(tmp_path / "out"), SharedConfig(), partitions=["AB"])


# ------------------------------------------------------------------ ENST, MDB, TMIDT


def enst_tree(root: Path) -> None:
    """Two drummers' wet mixes (one minus-one), a dry track the parser
    filters out, and a file whose annotations run past its audio (skipped)."""
    for drummer, name, sec, ann in (
        (1, "107_minus-one_salsa_sticks", 1.5, "0.10 bd\n0.30 sd\n0.50 chh\n0.90 cr\n1.30 sticks\n"),
        (1, "108_phrase_rock", 2.0, "0.05 bd\n0.62 sd\n0.70 rc\n1.40 ohh\n1.42 bd\n"),
        (2, "021_minus-one_funk", 1.0, "0.20 lft\n0.55 mt\n0.80 c\n"),
        (2, "022_past_the_audio", 0.5, "0.10 bd\n3.00 sd\n"),
    ):
        audio_dir = root / f"drummer_{drummer}" / "audio" / "wet_mix"
        ann_dir = root / f"drummer_{drummer}" / "annotation"
        audio_dir.mkdir(parents=True, exist_ok=True)
        ann_dir.mkdir(parents=True, exist_ok=True)
        write_wav(audio_dir / f"{name}.wav", tone(sec, 100 + 40 * drummer), SR)
        (ann_dir / f"{name}.txt").write_text(ann)
    dry = root / "drummer_1" / "audio" / "snare"
    dry.mkdir(parents=True)
    write_wav(dry / "107_minus-one_salsa_sticks.wav", tone(1.0), SR)


def mdb_tree(root: Path) -> None:
    """Drum-only and demucs-separated tracks of three genre splits, an
    unsplit track, and a no-drums mix the parser filters out."""
    audio, ann = root / "audio", root / "annotations" / "subclass"
    for d in ("drum_only", "demucs_separated", "no_drums"):
        (audio / d).mkdir(parents=True)
    ann.mkdir(parents=True)
    for i, genre in enumerate(("Punk", "FunkJazz", "Beatles", "Unlisted")):
        write_wav(audio / "drum_only" / f"MusicDelta_{genre}_Drum.wav", tone(1.0 + 0.3 * i), SR)
        (ann / f"MusicDelta_{genre}_subclass.txt").write_text(f"0.10 KD\n0.40 SD\n0.{5 + i}0 CHH\n0.90 RDC\n")
    write_wav(audio / "demucs_separated" / "MusicDelta_Punk_MIX_drums.wav", tone(1.0, 330), SR)
    write_wav(audio / "no_drums" / "MusicDelta_Punk_no_drums.wav", tone(1.0, 440), SR)


def tmidt_tree(root: Path) -> None:
    """Drum tracks with annotations, an accompaniment track, a track
    without annotations and one with a malformed line (skipped)."""
    ann = root / "annotations" / "drums_m"
    ann.mkdir(parents=True)
    for name, sec, text in (("track_01", 1.5, "0.10 0\n0.30 1\n0.50 3\n1.00 7\n1.20 6\n"),
                            ("track_02", 2.2, "0.70 2\n0.75 4\n1.50 5\n"),
                            ("track_03", 1.0, "0.10 0\n0.20 x\n")):
        write_wav(root / f"{name}.wav", tone(sec), SR)
        (ann / f"{name}.txt").write_text(text)
    write_wav(root / "track_01_accomp.wav", tone(1.5, 500), SR)
    (ann / "track_01_accomp.txt").write_text("0.10 0\n")
    write_wav(root / "track_04.wav", tone(1.0), SR)


TEXT_PARSERS = {"ENST": (enst_tree, tparsers.ENSTDrumTextParser, JENST),
                "MDB": (mdb_tree, tparsers.MDBDrumTextParser, JMDB),
                "TMIDT": (tmidt_tree, tparsers.TMIDTTextParser, JTMIDT)}


def parse_both(tmp_path: Path, name: str, chunk_size_mb: int) -> tuple[Path, Path]:
    """The corpus of `name` under tmp_path, parsed by both packages ->
    (the port's shard directory, the JAX package's)."""
    make_tree, port_parser, jax_parser = TEXT_PARSERS[name]
    root = tmp_path / name
    make_tree(root)
    kw = dict(dataset_path=str(root), dataset_name=name, audio_extension="wav", chunk_size_mb=chunk_size_mb)
    port_parser(tparsers.TextParserConfig(output_path=str(tmp_path / "port"), shared=SharedConfig(**FRAMING),
                                          **kw)).parse()
    jax_parser(JTextParserConfig(output_path=str(tmp_path / "jax"), shared=JSharedConfig(**FRAMING), **kw)).parse()
    return tmp_path / "port" / name / f"data@{SR}", tmp_path / "jax" / name / f"data@{SR}"


@pytest.mark.parametrize("chunk_size_mb", [512, 0], ids=["one-shard", "a-shard-a-row"])
@pytest.mark.parametrize("name", list(TEXT_PARSERS))
def test_text_shards_byte_equal_jax(tmp_path, name, chunk_size_mb):
    port_dir, jax_dir = parse_both(tmp_path, name, chunk_size_mb)
    ours, theirs = shard_bytes(tmp_path / "port"), shard_bytes(tmp_path / "jax")
    assert ours and ours.keys() == theirs.keys()
    assert ours == theirs
    if chunk_size_mb == 0:
        assert len(ours) > 2  # every row flushed its own shard


@pytest.mark.parametrize("name", ["ENST", "MDB"])
def test_eval_datasets_read_the_port_shards_as_jax_shards(tmp_path, name):
    port_dir, jax_dir = parse_both(tmp_path, name, 512)
    tok = MidiTokenizer(TokenizerConfig(ADTOF_mapping=True))
    cls = tdata.ENSTDataset if name == "ENST" else tdata.MDBDataset
    sides = []
    for d in (port_dir, jax_dir):
        cfg = EvalDataConfig(dataset_path=str(d), dataset_name=name, **FRAMING)
        ds = cls(cfg, tok)
        sides.append([ds[i] for i in range(len(ds))])
    assert len(sides[0]) >= 3
    for (wa, na), (wb, nb) in zip(*sides):
        np.testing.assert_array_equal(wa, wb)
        np.testing.assert_array_equal(na, nb)


def test_tmidt_dataset_reads_the_port_shards_as_jax_shards(tmp_path):
    port_dir, jax_dir = parse_both(tmp_path, "TMIDT", 512)
    tok = MidiTokenizer(TokenizerConfig(add_velocity=False))
    sides = []
    for d in (port_dir, jax_dir):
        cfg = TrainDataConfig(dataset_path=str(d), dataset_name="TMIDT", empty_tokens_percentage=0.0,
                              random_velocity_prob=0.5, max_tokens=32, **FRAMING)
        ds = tdata.TMIDTDataset(cfg, tok)
        rng = np.random.default_rng(1)
        sides.append([ds.example(i, rng) for i in range(len(ds))])
    assert len(sides[0]) >= 3
    for a, b in zip(*sides):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


# ------------------------------------------------------------------ the CLIs


def run_cli(module: str, config: Path, data: Path) -> subprocess.CompletedProcess:
    env = {**os.environ, "ADT_DATA": str(data), "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, "-m", module, str(config)], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)


def test_clis_run_as_modules(lakh_tree, tmp_path):
    """Both CLIs on temporary configs in the shipped configs' layout (paths
    through `${oc.env:ADT_DATA}`) write the JAX parsers' shards."""
    data = lakh_tree.parent
    framing = "shared:\n  input_sec: 0.64\n  time_res: 0.01\n  win_length: 256\n  sample_rate: 4000\n"
    lakh_cfg = tmp_path / "make_dataset.yaml"
    lakh_cfg.write_text(framing + 'preprocess:\n  dataset_name: lakh_matched\n  midi_root: "${oc.env:ADT_DATA}/lmd"\n'
                        '  dump_path: "${oc.env:ADT_DATA}/cli"\n  n_jobs: 1\n  partitions: ["A", "B"]\n')
    enst_tree(data / "ENST")
    enst_cfg = tmp_path / "ENST_preprocess.yaml"
    enst_cfg.write_text(framing + 'EvalDataPreprocess:\n  dataset_path: "${oc.env:ADT_DATA}/ENST"\n  drummers: null\n'
                        '  output_path: "${oc.env:ADT_DATA}/cli/"\n  dataset_name: "ENST"\n'
                        '  audio_extension: "wav"\n')
    for module, cfg in (("adt_str_tpu_torch.scripts.midi_parser", lakh_cfg),
                        ("adt_str_tpu_torch.scripts.text_parser", enst_cfg)):
        out = run_cli(module, cfg, data)
        assert out.returncode == 0, out.stderr
    JLakhMidiParser(str(lakh_tree), str(tmp_path / "jax"), JSharedConfig(**FRAMING),
                    partitions=["A", "B"]).create_dataset()
    JENST(JTextParserConfig(dataset_path=str(data / "ENST"), output_path=str(tmp_path / "jax"), dataset_name="ENST",
                            audio_extension="wav", shared=JSharedConfig(**FRAMING))).parse()
    ours = shard_bytes(data / "cli")
    assert ours and ours == shard_bytes(tmp_path / "jax")


def test_text_parser_cli_refuses_an_unknown_dataset(tmp_path):
    cfg = tmp_path / "x.yaml"
    cfg.write_text('EvalDataPreprocess:\n  dataset_path: "x"\n  output_path: "y"\n  dataset_name: "IDMT"\n')
    out = run_cli("adt_str_tpu_torch.scripts.text_parser", cfg, tmp_path)
    assert out.returncode != 0 and "Dataset name IDMT not supported" in out.stderr


def test_without_pyarrow_the_writers_raise_naming_it(lakh_tree, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    with pytest.raises(ImportError, match="pyarrow"):
        LakhMidiParser(str(lakh_tree), str(tmp_path / "out"), SharedConfig(**FRAMING), partitions=["A"]).create_dataset()
    enst_tree(tmp_path / "ENST")
    with pytest.raises(ImportError, match="pyarrow"):
        tparsers.ENSTDrumTextParser(tparsers.TextParserConfig(
            dataset_path=str(tmp_path / "ENST"), output_path=str(tmp_path / "out"), dataset_name="ENST",
            audio_extension="wav", shared=SharedConfig(**FRAMING))).parse()
