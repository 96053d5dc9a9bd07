"""The port's training data layer against the JAX package's, on the CPU:
the tokenizer's encode side, the Lakh and TMIDT datasets' batches (read
from one parquet shard written here, or from rows passed in), the bucket
trims and collate, the prefetch thread, and the typed sections of every
shipped training config. Batches must be byte-equal to JAX's."""

import dataclasses
import threading
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from adt_str_tpu.config import FrameworkConfig as JFrameworkConfig
from adt_str_tpu.config import TokenizerConfig as JTokenizerConfig
from adt_str_tpu.config import TrainDataConfig as JTrainDataConfig
from adt_str_tpu.data import datasets as jdata
from adt_str_tpu.data.lakh import SCHEMA as LAKH_SCHEMA
from adt_str_tpu.domain.tokenizer import MidiTokenizer as JMidiTokenizer
from adt_str_tpu_torch.config import FrameworkConfig, TokenizerConfig, TrainDataConfig
from adt_str_tpu_torch.data import datasets as tdata
from adt_str_tpu_torch.domain.tokenizer import MidiTokenizer

REPO = Path(__file__).resolve().parent.parent
SR = 4000
GM_PITCHES = [35, 36, 38, 40, 42, 44, 46, 49, 51, 56]


def random_notes(rng, n, onset_hi=2.9):
    on = rng.uniform(0, onset_hi, n).astype(np.float32)
    return np.stack([on, on + 0.1, rng.choice(GM_PITCHES, n), rng.integers(0, 128, n)], 1).astype(np.float32)


def tokenizers(add_velocity):
    kw = dict(add_velocity=add_velocity)
    return MidiTokenizer(TokenizerConfig(**kw)), JMidiTokenizer(JTokenizerConfig(**kw))


# ------------------------------------------------------------ tokenizer


@pytest.mark.parametrize("add_velocity", [True, False], ids=["velocity", "no-velocity"])
@pytest.mark.parametrize("seed", range(6))
def test_encode_side_equals_jax(seed, add_velocity):
    """Seeded note sets (the first empty, onsets on and off the 10 ms grid,
    up to 2.95 s) -> the same token rows; `encode_padded` at lengths that
    fit and that overflow (notes dropped whole, EOS kept)."""
    tok, jtok = tokenizers(add_velocity)
    rng = np.random.default_rng(seed)
    notes = random_notes(rng, 0 if seed == 0 else int(rng.integers(1, 60)))
    if seed == 1:  # grid onsets whose float32 product truncates below the grid
        notes[:, 0] = np.float32(rng.integers(0, 296, len(notes)) * 0.01)
    got = tok.notes_to_adt_tokens(notes)
    np.testing.assert_array_equal(got, jtok.notes_to_adt_tokens(notes))
    assert got.dtype == np.int64
    for max_tokens in (2, 5, 16, 64, 512):
        padded, length = tok.encode_padded(notes, max_tokens)
        want, want_length = jtok.encode_padded(notes, max_tokens)
        np.testing.assert_array_equal(padded, want)
        assert (length, padded.dtype) == (want_length, want.dtype)
    np.testing.assert_array_equal(tok.empty_adt_tokens(), jtok.empty_adt_tokens())
    assert tok.tokens_per_note == jtok.tokens_per_note


def test_time_token_out_of_range_raises_as_jax():
    tok, jtok = tokenizers(True)
    late = np.array([[2.96, 3.0, 36, 100]], np.float32)
    for t in (tok, jtok):
        with pytest.raises(AssertionError, match="Time token"):
            t.notes_to_adt_tokens(late)


# ------------------------------------------------------------ datasets


def write_lakh_shard(path, n=41, seed=0):
    rng = np.random.default_rng(seed)
    rows = {"midi_id": [], "segment_number": [], "notes": []}
    for i in range(n):
        k = int(rng.integers(1, 40)) if i % 7 else int(rng.integers(100, 180))  # some overflow max_tokens
        rows["midi_id"].append(f"id{i}")
        rows["segment_number"].append(i % 3)
        rows["notes"].append(random_notes(rng, k, onset_hi=0.6).tobytes())
    pq.write_table(pa.table(rows, schema=LAKH_SCHEMA), path)
    return rows


def write_tmidt_shard(path, n=37, seed=1):
    rng = np.random.default_rng(seed)
    rows = {"audio_id": [], "audio": [], "sample_rate": [], "notes": []}
    for i in range(n):
        sr = SR if i % 4 else 2 * SR  # some rows need resampling
        samples = int(rng.integers(int(0.3 * sr), int(0.9 * sr)))  # shorter and longer than a chunk
        rows["audio_id"].append(f"t{i}.mp3")
        rows["audio"].append((rng.normal(size=samples) * 0.2).astype(np.float32).tobytes())
        rows["sample_rate"].append(sr)
        rows["notes"].append(random_notes(rng, int(rng.integers(0, 30)), onset_hi=0.6).tobytes())
    schema = pa.schema([pa.field("audio_id", pa.string()), pa.field("audio", pa.binary()),
                        pa.field("sample_rate", pa.int32()), pa.field("notes", pa.binary())])
    pq.write_table(pa.table(rows, schema=schema), path)
    return rows


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    lakh_rows = write_lakh_shard(d / "lakh.parquet")
    tmidt_rows = write_tmidt_shard(d / "tmidt.parquet")
    return {"lakh": (str(d / "lakh.parquet"), lakh_rows), "tmidt": (str(d / "tmidt.parquet"), tmidt_rows)}


def data_configs(name, path, **kw):
    base = dict(dataset_path=path, dataset_name=name, empty_tokens_percentage=0.15, random_velocity_prob=0.5,
                input_sec=0.64, sample_rate=SR, **kw)
    return TrainDataConfig(**base), JTrainDataConfig(**base)


def make_datasets(name, shards, rows=False, **kw):
    path, shard_rows = shards[name.lower()]
    cfg, jcfg = data_configs(name, path, **kw)
    add_velocity = name == "Lakh"
    tok, jtok = tokenizers(add_velocity)
    if name == "Lakh":
        port = tdata.LakhDataset(cfg, tok, max_notes=64, rows=shard_rows if rows else None)
        return port, jdata.LakhDataset(jcfg, jtok, max_notes=64)
    return tdata.TMIDTDataset(cfg, tok, rows=shard_rows if rows else None), jdata.TMIDTDataset(jcfg, jtok)


def assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert g[k].tobytes() == w[k].tobytes(), k


CASES = {
    "shuffled": dict(batch_size=4, shuffle=True, skip=0),
    "skip": dict(batch_size=4, shuffle=True, skip=3),
    "eval-order": dict(batch_size=5, shuffle=False, skip=0),
    "eval-order-skip": dict(batch_size=6, shuffle=False, skip=1),
}


@pytest.mark.parametrize("rows", [False, True], ids=["shard", "rows"])
@pytest.mark.parametrize("holdout", [0.0, 0.25], ids=["no-holdout", "holdout"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", ["Lakh", "TMIDT"])
def test_batches_equal_jax(name, case, holdout, rows, shards):
    """The same seed gives byte-equal batches: order, holdout prefix,
    per-example seeds, skip, augmentations, the length quirk and the note
    and token bucket trims (max_tokens 160 overflows and trims)."""
    port, jax_ds = make_datasets(name, shards, rows=rows, max_tokens=160, holdout_fraction=holdout)
    assert len(port) == len(jax_ds)
    kw = dict(CASES[case])
    bs = kw.pop("batch_size")
    got = list(port.batches(bs, np.random.default_rng([7, 1]), **kw))
    want = list(jax_ds.batches(bs, np.random.default_rng([7, 1]), **kw))
    assert_batches_equal(got, want)
    if name == "Lakh" and bs == 4:  # the trims ran: some batches are cut below 160 tokens and 64 notes
        assert {b["tokens"].shape[1] for b in got} <= {64, 128, 160}
        assert min(b["notes"].shape[1] for b in got) < 64


def test_skip_replays_the_straight_epoch(shards):
    """Batches after `skip` equal the straight epoch's same batches."""
    port, _ = make_datasets("Lakh", shards, max_tokens=160)
    straight = list(port.batches(4, np.random.default_rng(3)))
    assert_batches_equal(list(port.batches(4, np.random.default_rng(3), skip=5)), straight[5:])


def test_rows_need_their_columns(shards):
    cfg, _ = data_configs("TMIDT", "")
    with pytest.raises(ValueError, match="columns"):
        tdata.TMIDTDataset(cfg, MidiTokenizer(TokenizerConfig()), rows={"audio": [], "notes": []})


@pytest.mark.parametrize("seed", range(4))
def test_trims_and_collate_equal_jax(seed):
    rng = np.random.default_rng(seed)
    B, N, T = 5, 128, 512
    mask = np.arange(N)[None] < rng.integers(0, 70, (B, 1))
    notes = rng.normal(size=(B, N, 4)).astype(np.float32) * mask[..., None]
    lengths = rng.integers(3, 300, B)
    tokens = np.where(np.arange(T)[None] < lengths[:, None], rng.integers(0, 600, (B, T)), 1).astype(np.int64)
    if seed == 0:
        mask[:] = False
        tokens[:, 2:] = 1
    examples = [{"notes": notes[i], "note_mask": mask[i], "tokens": tokens[i], "token_lengths": np.int64(lengths[i])}
                for i in range(B)]
    assert_batches_equal([tdata.collate(examples)], [jdata.collate(examples)])
    batch = {"tokens": tokens}
    assert_batches_equal([tdata.trim_token_bucket(batch)], [jdata.trim_token_bucket(batch)])
    assert (tdata.NOTE_BUCKET, tdata.TOKEN_BUCKET) == (jdata.NOTE_BUCKET, jdata.TOKEN_BUCKET)


# ------------------------------------------------------------ prefetch


def test_prefetch_keeps_order_and_bounds_the_thread():
    assert list(tdata.prefetch_batches(iter(range(50)), depth=3)) == list(range(50))
    produced = []

    def slow():
        for i in range(1000):
            produced.append(i)
            yield i

    it = tdata.prefetch_batches(slow(), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()  # an abandoned consumer releases the thread
    n = len(produced)
    threading.Event().wait(0.5)
    assert len(produced) <= n + 1 and len(produced) < 10


def test_prefetch_raises_the_producers_error_in_the_consumer():
    def broken():
        yield 1
        yield 2
        raise KeyError("bad row")

    got = []
    with pytest.raises(KeyError, match="bad row"):
        for x in tdata.prefetch_batches(broken(), depth=1):
            got.append(x)
    assert got == [1, 2]


# ------------------------------------------------------------ configs


TRAIN_SECTIONS = ("shared", "tokenizer", "model", "train_data", "training", "logging", "checkpoint", "experiment",
                  "inference", "serving", "mesh")


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in (REPO / "configs" / "train").glob("*.yaml")))
def test_train_configs_parse_alike_in_both_packages(path, monkeypatch):
    """Every shipped training config through the port's own reader (PyYAML
    blocked, as on the card's machine) gives the JAX package's typed
    sections; the port's synthesiser fields equal JAX's same-named ones."""
    jcfg = JFrameworkConfig.from_yaml(REPO / path)
    monkeypatch.setitem(__import__("sys").modules, "yaml", None)
    cfg = FrameworkConfig.from_yaml(REPO / path)
    for s in TRAIN_SECTIONS:
        assert dataclasses.asdict(getattr(cfg, s)) == dataclasses.asdict(getattr(jcfg, s)), s
    if jcfg.synthetiser is not None:
        jsynth = dataclasses.asdict(jcfg.synthetiser)
        assert {k: jsynth[k] for k in dataclasses.asdict(cfg.synthetiser)} == dataclasses.asdict(cfg.synthetiser)
    else:
        assert cfg.synthetiser is None
