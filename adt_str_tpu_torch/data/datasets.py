"""Training and evaluation datasets and the host input pipeline.

Port of `adt_str_tpu/data/datasets.py` (its own copy). pyarrow is imported
only where a shard is read: the machine with the card has none, so every
dataset also takes its rows from the caller (`rows=`, the shard's columns
as lists) instead of the shards its config names.

Training (`LakhDataset`, `TMIDTDataset`): every example has fixed shapes,
notes padded to `max_notes` and tokens to `max_tokens` with PAD. A Lakh
example is a note list (the trainer renders its audio on the device); a
TMIDT example is real audio. The augmentations (injected empty segments,
random velocities) draw from a per-example numpy generator.
`_epoch_batches` shuffles an epoch (the holdout prefix excluded), draws
every example's seed up front so that skipping the first `skip` batches on
resume replays the same examples, strides the epoch by process in a
multi-process run, and `collate`s them: the reference's length quirk,
then (in one process) the note and token bucket trims. `prefetch_batches`
assembles batches on a thread, a bounded number ahead.

Evaluation (`EvalDataset` and its ENST and MDB variants): `audio_id`,
audio, sample rate and notes of each item; the audio resampled and
peak-normalised, the notes remapped through the tokenizer
(`map_notes_to_Gm_custom`), with the reference's filters (ENST minus-one,
accompaniment splits and drummers; MDB folds by the `split` column, and
the demucs flag). `batches` yields raw lists, as the reference's eval
collate does.
"""

from __future__ import annotations

import glob as globlib
import os
from typing import Iterator, Optional

import numpy as np
import torch

from adt_str_tpu_torch.config import EvalDataConfig, TrainDataConfig
from adt_str_tpu_torch.domain.tokenizer import MidiTokenizer
from adt_str_tpu_torch.models.adt import collate_token_lengths
from adt_str_tpu_torch.synth.render import pad_notes
from adt_str_tpu_torch.utils.audio_io import normalize, resample

NOTE_BUCKET = 16
TOKEN_BUCKET = 64

# the fixed ENST accompaniment splits, by track name
ENST_SPLITS = {
    0: [
        "143_MIDI-minus-one_fusion-125_sticks", "107_minus-one_salsa_sticks",
        "108_minus-one_rock-60s_sticks", "109_minus-one_metal_sticks",
        "110_minus-one_musette_brushes", "111_minus-one_funky_rods",
        "112_minus-one_funk_rods", "113_minus-one_charleston_sticks",
        "114_minus-one_celtic-rock_brushes", "115_minus-one_bossa_brushes",
        "121_MIDI-minus-one_bigband_brushes", "123_MIDI-minus-one_blues-102_sticks",
        "125_MIDI-minus-one_country-120_brushes", "127_MIDI-minus-one_disco-108_sticks",
        "129_MIDI-minus-one_funk-101_sticks", "131_MIDI-minus-one_grunge_sticks",
        "133_MIDI-minus-one_nu-soul_sticks", "135_MIDI-minus-one_rock-113_sticks",
        "137_MIDI-minus-one_rock'n'roll-188_sticks",
        "139_MIDI-minus-one_soul-120-marvin-gaye_sticks",
        "141_MIDI-minus-one_soul-98_sticks",
    ],
    1: [
        "152_MIDI-minus-one_fusion-125_sticks", "115_minus-one_salsa_sticks",
        "116_minus-one_rock-60s_sticks", "117_minus-one_metal_sticks",
        "118_minus-one_musette_brushes", "119_minus-one_funky_sticks",
        "120_minus-one_funk_sticks", "121_minus-one_charleston_sticks",
        "122_minus-one_celtic-rock_sticks",
        "123_minus-one_celtic-rock-better-take_sticks",
        "124_minus-one_bossa_sticks", "130_MIDI-minus-one_bigband_sticks",
        "132_MIDI-minus-one_blues-102_sticks", "134_MIDI-minus-one_country-120_sticks",
        "136_MIDI-minus-one_disco-108_sticks", "138_MIDI-minus-one_funk-101_sticks",
        "140_MIDI-minus-one_grunge_sticks", "142_MIDI-minus-one_nu-soul_sticks",
        "144_MIDI-minus-one_rock-113_sticks",
        "146_MIDI-minus-one_rock'n'roll-188_sticks",
        "148_MIDI-minus-one_soul-120-marvin-gaye_sticks",
        "150_MIDI-minus-one_soul-98_sticks",
    ],
    2: [
        "162_MIDI-minus-one_fusion-125_sticks", "126_minus-one_salsa_sticks",
        "127_minus-one_rock-60s_sticks", "128_minus-one_metal_sticks",
        "129_minus-one_musette_sticks", "130_minus-one_funky_sticks",
        "131_minus-one_funk_sticks", "132_minus-one_charleston_sticks",
        "133_minus-one_celtic-rock_sticks", "134_minus-one_bossa_sticks",
        "140_MIDI-minus-one_bigband_sticks", "142_MIDI-minus-one_blues-102_sticks",
        "144_MIDI-minus-one_country-120_sticks", "146_MIDI-minus-one_disco-108_sticks",
        "148_MIDI-minus-one_funk-101_sticks", "150_MIDI-minus-one_grunge_sticks",
        "152_MIDI-minus-one_nu-soul_sticks", "154_MIDI-minus-one_rock-113_sticks",
        "156_MIDI-minus-one_rock'n'roll-188_sticks",
        "158_MIDI-minus-one_soul-120-marvin-gaye_sticks",
        "160_MIDI-minus-one_soul-98_sticks",
    ],
}

# MDB genre folds (the reference's eval config). Kept as documentation:
# filtering reads the parquet's `split` column (see MDBDataset._apply_filters).
MDB_SPLITS = {
    0: ["MusicDelta_Punk", "MusicDelta_CoolJazz", "MusicDelta_Disco",
        "MusicDelta_SwingJazz", "MusicDelta_Rockabilly", "MusicDelta_Gospel",
        "MusicDelta_BebopJazz"],
    1: ["MusicDelta_FunkJazz", "MusicDelta_FreeJazz", "MusicDelta_Reggae",
        "MusicDelta_LatinJazz", "MusicDelta_Britpop", "MusicDelta_FusionJazz",
        "MusicDelta_Shadows", "MusicDelta_80sRock"],
    2: ["MusicDelta_Beatles", "MusicDelta_Grunge", "MusicDelta_Zeppelin",
        "MusicDelta_ModalJazz", "MusicDelta_Country1", "MusicDelta_SpeedMetal",
        "MusicDelta_Rock", "MusicDelta_Hendrix"],
}


def _notes_from_bytes(binary: bytes) -> np.ndarray:
    return np.frombuffer(binary, dtype=np.float32).reshape(-1, 4).copy()


def _read_parquet_files(paths: list[str], columns: list[str]) -> dict[str, list]:
    try:
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError("reading parquet shards needs the pyarrow package, which is not installed; "
                          "pass the rows instead") from e
    data: dict[str, list] = {c: [] for c in columns}
    for p in sorted(paths):
        table = pq.read_table(p, columns=columns)
        for c in columns:
            data[c].extend(table.column(c).to_pylist())
    return data


def _expand_dataset_path(path: str) -> list[str]:
    """A file, a glob, or a directory of parquet files."""
    if os.path.isdir(path):
        return sorted(globlib.glob(os.path.join(path, "*.parquet")))
    if any(ch in path for ch in "*?["):
        return sorted(globlib.glob(path))
    return [path]


def _normalize_splits(splits) -> Optional[list[int]]:
    if splits is None:
        return None
    if isinstance(splits, int):
        return [splits]
    return list(splits)


def trim_note_bucket(batch: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Trim the padded note dim of "notes" and "note_mask" to the batch's
    longest row, rounded up to NOTE_BUCKET (at least one bucket): the
    render's placement cost follows the padded note count."""
    if "note_mask" not in batch:
        return batch
    m = batch["note_mask"]
    any_col = m.any(axis=0)
    hi = int(np.nonzero(any_col)[0].max() + 1) if any_col.any() else 0
    bucket = max(NOTE_BUCKET, -(-hi // NOTE_BUCKET) * NOTE_BUCKET)
    if bucket < m.shape[1]:
        batch = dict(batch)
        batch["notes"] = batch["notes"][:, :bucket]
        batch["note_mask"] = m[:, :bucket]
    return batch


def trim_token_bucket(batch: dict[str, np.ndarray], pad_token: int = 1) -> dict[str, np.ndarray]:
    """Trim the padded token dim of "tokens" to the last column that holds a
    token other than PAD, rounded up to TOKEN_BUCKET (at least one bucket).
    Loss-exact: the loss ignores PAD labels and the masks come from the
    lengths."""
    if "tokens" not in batch:
        return batch
    t = batch["tokens"]
    non_pad = (t != pad_token).any(axis=0)
    hi = int(np.nonzero(non_pad)[0].max() + 1) if non_pad.any() else 2
    bucket = max(TOKEN_BUCKET, -(-hi // TOKEN_BUCKET) * TOKEN_BUCKET)
    if bucket < t.shape[1]:
        batch = dict(batch)
        batch["tokens"] = t[:, :bucket]
    return batch


def collate(examples: list[dict[str, np.ndarray]], trim: bool = True) -> dict[str, np.ndarray]:
    """Stack fixed-shape examples, apply the length quirk, then (with
    `trim`) the note and token bucket trims."""
    batch = {key: np.stack([e[key] for e in examples]) for key in examples[0]}
    batch["token_lengths"] = collate_token_lengths(torch.from_numpy(batch["token_lengths"].astype(np.int64))).numpy()
    return trim_token_bucket(trim_note_bucket(batch)) if trim else batch


def _epoch_batches(dataset, batch_size: int, rng: np.random.Generator, shuffle: bool, skip: int,
                   process_index: int = 0, process_count: int = 1) -> Iterator[dict[str, np.ndarray]]:
    """One epoch of collated full batches of `batch_size` rows. Shuffled,
    the epoch leaves out the `holdout_fraction` prefix (the in-training
    eval stream) and permutes the rest with `rng`; then one seed per
    example is drawn from `rng` over the whole epoch, so the examples of
    batch b are the same whether or not the first `skip` batches were
    skipped. With `process_count` > 1, process `process_index` takes every
    `process_count`-th example and seed from its index on (JAX's per-host
    stride), and no batch is trimmed: ranks whose batches had other shapes
    would deadlock in the collectives."""
    order = np.arange(len(dataset))
    if shuffle:
        holdout = int(len(dataset) * dataset.config.holdout_fraction)
        order = order[holdout:]
        rng.shuffle(order)
    seeds = rng.integers(0, 2**62, size=len(order))
    if process_count > 1:
        order = order[process_index::process_count]
        seeds = seeds[process_index::process_count]
    for b in range(skip, len(order) // batch_size):
        idx = order[b * batch_size : (b + 1) * batch_size]
        sds = seeds[b * batch_size : (b + 1) * batch_size]
        examples = [dataset.example(int(i), np.random.default_rng(int(s))) for i, s in zip(idx, sds)]
        yield collate(examples, trim=process_count == 1)


def _train_rows(config: TrainDataConfig, rows: Optional[dict[str, list]], columns: list[str]) -> dict[str, list]:
    """`columns` of the caller's rows, or read from the shards `config` names."""
    if rows is not None:
        missing = [c for c in columns if c not in rows]
        if missing:
            raise ValueError(f"the rows lack the columns {missing}")
        return rows
    if config.partitions is None:
        files = _expand_dataset_path(config.dataset_path)
    else:
        files = [os.path.join(config.dataset_path, f"{p}.parquet") for p in config.partitions]
    return _read_parquet_files(files, columns)


class LakhDataset:
    """Lakh drum-note segments -> (notes, mask, tokens) examples; the audio
    is rendered on the device by the trainer. `rows`: {"notes": [float32
    (n, 4) rows as bytes], ...}, else the config's shards are read."""

    def __init__(self, config: TrainDataConfig, tokenizer: MidiTokenizer, max_notes: int = 128,
                 rows: Optional[dict[str, list]] = None):
        self.config = config
        self.tokenizer = tokenizer
        self.max_notes = max_notes
        self.notes_bytes: list[bytes] = _train_rows(config, rows, ["notes"])["notes"]

    def __len__(self) -> int:
        return len(self.notes_bytes)

    def example(self, index: int, rng: np.random.Generator) -> dict[str, np.ndarray]:
        """With probability `empty_tokens_percentage` an empty segment
        ([BOS, silence, EOS], no notes); else the segment's notes remapped
        (random velocities with probability `random_velocity_prob`) and cut
        to `max_notes` and to what fits in `max_tokens`."""
        cfg, tok = self.config, self.tokenizer
        if rng.random() < cfg.empty_tokens_percentage:
            notes = np.zeros((0, 4), dtype=np.float32)
        else:
            notes = _notes_from_bytes(self.notes_bytes[index])
            random_velocity = bool(cfg.random_velocity_prob) and rng.random() < cfg.random_velocity_prob
            notes = tok.map_notes_to_Gm_custom(notes, random_velocity=random_velocity, rng=rng)
        if len(notes) == 0:
            tokens = tok.empty_adt_tokens()
            padded = np.full(cfg.max_tokens, tok.pad_token, dtype=np.int64)
            padded[: len(tokens)] = tokens
            length = len(tokens)
            note_arr = np.zeros((self.max_notes, 4), dtype=np.float32)
            note_mask = np.zeros(self.max_notes, dtype=bool)
        else:
            n_fit = (cfg.max_tokens - 2) // tok.tokens_per_note
            notes = notes[: min(self.max_notes, n_fit)]
            padded, length = tok.encode_padded(notes, cfg.max_tokens)
            note_arr, note_mask = pad_notes(notes, self.max_notes)
        return {"notes": note_arr, "note_mask": note_mask, "tokens": padded, "token_lengths": np.int64(length)}

    def batches(self, batch_size: int, rng: np.random.Generator, shuffle: bool = True, skip: int = 0,
                process_index: int = 0, process_count: int = 1) -> Iterator[dict[str, np.ndarray]]:
        yield from _epoch_batches(self, batch_size, rng, shuffle, skip, process_index, process_count)


class TMIDTDataset:
    """Real-audio training segments -> (wave, tokens) examples. `rows`:
    {"audio": [float32 samples as bytes], "sample_rate": [...], "notes":
    [float32 (n, 4) rows as bytes]}, else the config's shards are read."""

    def __init__(self, config: TrainDataConfig, tokenizer: MidiTokenizer, rows: Optional[dict[str, list]] = None):
        self.config = config
        self.tokenizer = tokenizer
        data = _train_rows(config, rows, ["audio", "sample_rate", "notes"])
        self.audio_bytes = data["audio"]
        self.sample_rates = data["sample_rate"]
        self.notes_bytes = data["notes"]

    def __len__(self) -> int:
        return len(self.audio_bytes)

    def _audio(self, index: int) -> np.ndarray:
        """The segment's audio at the config's rate, peak-normalised, cut or
        zero-padded to chunk_samples."""
        wave = np.frombuffer(self.audio_bytes[index], dtype=np.float32).copy()
        sr = int(self.sample_rates[index])
        if sr != self.config.sample_rate:
            wave = resample(wave, sr, self.config.sample_rate)
        wave = wave / (np.abs(wave).max() + 1e-8)
        out = np.zeros(self.config.chunk_samples, dtype=np.float32)
        n = min(len(wave), len(out))
        out[:n] = wave[:n]
        return out

    def example(self, index: int, rng: np.random.Generator) -> dict[str, np.ndarray]:
        """As `LakhDataset.example`, with audio. An injected empty segment is
        silence with [BOS, silence, EOS]; a segment without notes encodes as
        [BOS, EOS], as in the reference."""
        cfg, tok = self.config, self.tokenizer
        if rng.random() < cfg.empty_tokens_percentage:
            wave = np.zeros(cfg.chunk_samples, dtype=np.float32)
            tokens = tok.empty_adt_tokens()
            padded = np.full(cfg.max_tokens, tok.pad_token, dtype=np.int64)
            padded[: len(tokens)] = tokens
            return {"wavs": wave, "tokens": padded, "token_lengths": np.int64(len(tokens))}
        wave = self._audio(index)
        notes = _notes_from_bytes(self.notes_bytes[index])
        random_velocity = bool(cfg.random_velocity_prob) and rng.random() < cfg.random_velocity_prob
        notes = tok.map_notes_to_Gm_custom(notes, random_velocity=random_velocity, rng=rng)
        n_fit = (cfg.max_tokens - 2) // tok.tokens_per_note
        padded, length = tok.encode_padded(notes[:n_fit], cfg.max_tokens)
        return {"wavs": wave, "tokens": padded, "token_lengths": np.int64(length)}

    def batches(self, batch_size: int, rng: np.random.Generator, shuffle: bool = True, skip: int = 0,
                process_index: int = 0, process_count: int = 1) -> Iterator[dict[str, np.ndarray]]:
        yield from _epoch_batches(self, batch_size, rng, shuffle, skip, process_index, process_count)


def prefetch_batches(iterator: Iterator, depth: int = 2) -> Iterator:
    """`iterator`'s items, assembled on a thread at most `depth` ahead. An
    error in the thread is raised in the consumer; a consumer that stops
    early releases the thread (its puts time out and check a stop flag)."""
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    error: list[BaseException] = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item):
                    return
        except BaseException as e:  # raised again in the consumer
            error.append(e)
        finally:
            put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                return
            yield item
    finally:
        stop.set()


class EvalDataset:
    """(resampled, peak-normalised audio, remapped notes) items of a parquet shard."""

    COLUMNS = ["audio_id", "audio", "sample_rate", "notes"]

    def __init__(self, config: EvalDataConfig, tokenizer: MidiTokenizer):
        self.config = config
        self.tokenizer = tokenizer
        self.data = _read_parquet_files(_expand_dataset_path(config.dataset_path), self.COLUMNS)
        self._apply_filters()

    def _apply_filters(self) -> None:
        pass

    def _keep(self, keep: list[bool]) -> None:
        for key in self.data:
            self.data[key] = [v for v, k in zip(self.data[key], keep) if k]

    def __len__(self) -> int:
        return len(self.data["audio"])

    def __getitem__(self, index: int) -> tuple[np.ndarray, np.ndarray]:
        audio = np.frombuffer(self.data["audio"][index], dtype=np.float32).copy()
        sr = int(self.data["sample_rate"][index])
        if sr != self.config.sample_rate:
            audio = resample(audio, sr, self.config.sample_rate)
        audio = normalize(audio)
        notes = _notes_from_bytes(self.data["notes"][index])
        if len(notes):
            notes = self.tokenizer.map_notes_to_Gm_custom(notes)
        return audio.astype(np.float32), notes

    def batches(self, batch_size: int) -> Iterator[dict[str, list]]:
        """{"wavs": [...], "notes": [...]} lists of up to `batch_size` items."""
        for b in range(-(-len(self) // batch_size)):
            items = [self[i] for i in range(b * batch_size, min((b + 1) * batch_size, len(self)))]
            yield {"wavs": [it[0] for it in items], "notes": [it[1] for it in items]}


class ENSTDataset(EvalDataset):
    COLUMNS = ["audio_id", "drummer", "audio", "sample_rate", "notes"]

    def _apply_filters(self) -> None:
        cfg = self.config
        if cfg.minus_one:
            self._keep(["minus-one" in aid for aid in self.data["audio_id"]])
        splits = _normalize_splits(cfg.splits)
        if splits is not None:
            names = [n for s in splits for n in ENST_SPLITS[s]]
            self._keep([any(n in aid for n in names) for aid in self.data["audio_id"]])
        if cfg.drummers is not None:
            self._keep([any(str(d) in drummer for d in cfg.drummers) for drummer in self.data["drummer"]])


class MDBDataset(EvalDataset):
    COLUMNS = ["audio_id", "audio", "sample_rate", "notes", "split", "is_demucs_separated"]

    def _apply_filters(self) -> None:
        cfg = self.config
        splits = _normalize_splits(cfg.splits)
        if splits is not None:
            # divergence, kept from the JAX package: the reference matches
            # track names by substring, where split 2's "MusicDelta_Rock"
            # also matches split 0's "MusicDelta_Rockabilly"; the parquet's
            # `split` column, written from exact fold tables, decides here
            # (with every split selected the two agree)
            want = set(splits)
            self._keep([int(s) in want for s in self.data["split"]])
        self._keep([bool(f) == bool(cfg.demucs_separated) for f in self.data["is_demucs_separated"]])
