"""Evaluation datasets and the note-bucket trim of a training batch.

Port of `adt_str_tpu/data/datasets.py` (its own copy of the parts the
evaluation and the bench use): `EvalDataset` and its ENST and MDB variants
read `audio_id`, audio, sample rate and note columns from parquet shards,
resample and peak-normalise each item's audio and remap its notes through
the tokenizer (`map_notes_to_Gm_custom`), with the reference's filters
(ENST minus-one, accompaniment splits and drummers; MDB folds by the
`split` column, and the demucs flag). `batches` yields raw lists, as the
reference's eval collate does. pyarrow is imported only where a shard is
read: the machine with the card has none.

`trim_note_bucket` trims a padded note batch to its longest row, rounded up
to `NOTE_BUCKET`, as the JAX collate does before a synthesis step.
"""

from __future__ import annotations

import glob as globlib
import os
from typing import Iterator, Optional

import numpy as np

from adt_str_tpu_torch.config import EvalDataConfig
from adt_str_tpu_torch.domain.tokenizer import MidiTokenizer
from adt_str_tpu_torch.utils.audio_io import normalize, resample

NOTE_BUCKET = 16

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
        raise ImportError("reading the evaluation shards needs the pyarrow package, which is not installed") from e
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
