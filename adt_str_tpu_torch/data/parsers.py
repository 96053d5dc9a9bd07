"""Eval and train set text parsers: TMIDT, MDB-Drums, ENST-Drums -> parquet shards.

Port of `adt_str_tpu/data/parsers.py` (its own copy): the same annotation
formats, label -> MIDI maps, split tables, parquet schemas (audio as raw
float32 bytes), demucs / wet-mix / drummer file filters and size-based
shard flushing, so the shards are byte-equal to the JAX parsers'. Host-side
preprocessing that launches no kernel; pyarrow is imported where the shards
are written (`pyarrow_modules`).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from glob import glob
from pathlib import Path
from typing import Optional

import numpy as np

from adt_str_tpu_torch.config import SharedConfig
from adt_str_tpu_torch.domain.segmenter import Segmenter
from adt_str_tpu_torch.utils.audio_io import load_and_resample
from adt_str_tpu_torch.utils.mappings import ENST_TO_STANDARD_MIDI, MDB_TO_STANDARD_MIDI, TMIDT_TO_STANDARD_MIDI
from adt_str_tpu_torch.utils.midi_utils import MidiUtils

logger = logging.getLogger(__name__)

MDB_FILE_SPLITS = {
    0: ["MusicDelta_Punk_Drum", "MusicDelta_CoolJazz_Drum", "MusicDelta_Disco_Drum",
        "MusicDelta_SwingJazz_Drum", "MusicDelta_Rockabilly_Drum",
        "MusicDelta_Gospel_Drum", "MusicDelta_BebopJazz_Drum"],
    1: ["MusicDelta_FunkJazz_Drum", "MusicDelta_FreeJazz_Drum", "MusicDelta_Reggae_Drum",
        "MusicDelta_LatinJazz_Drum", "MusicDelta_Britpop_Drum",
        "MusicDelta_FusionJazz_Drum", "MusicDelta_Shadows_Drum", "MusicDelta_80sRock_Drum"],
    2: ["MusicDelta_Beatles_Drum", "MusicDelta_Grunge_Drum", "MusicDelta_Zeppelin_Drum",
        "MusicDelta_ModalJazz_Drum", "MusicDelta_Country1_Drum",
        "MusicDelta_SpeedMetal_Drum", "MusicDelta_Rock_Drum", "MusicDelta_Hendrix_Drum"],
}


def pyarrow_modules():
    """(pyarrow, pyarrow.parquet), or an ImportError that names the package."""
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError("writing parquet shards needs the pyarrow package, which is not installed") from e
    return pa, pq


def arrow_schema(pa, fields: tuple) -> "pa.Schema":
    """((name, pyarrow type name), ...) -> a pyarrow schema."""
    return pa.schema([pa.field(name, getattr(pa, kind)()) for name, kind in fields])


@dataclass
class TextParserConfig:
    dataset_path: str
    output_path: str
    dataset_name: str
    audio_extension: str
    shared: SharedConfig
    drummers: Optional[list[int]] = None
    dataset_size: str = "m"  # TMIDT: 'm' or 'l'
    drums_only: bool = True
    chunk_size_mb: int = 512
    num_audio_files: Optional[int] = None


class DrumTextParser:
    """Base: file discovery and size-flushed parquet shards
    (`<output_path>/<dataset_name>/data@<sr>/NNNN.parquet`)."""

    SCHEMA: tuple = ()

    def __init__(self, config: TextParserConfig):
        self.config = config
        self.shared = config.shared
        self.audio_data_files = sorted(
            glob(os.path.join(config.dataset_path, f"**/*.{config.audio_extension}"), recursive=True)
        )
        self.parquet_path = os.path.join(
            config.output_path, config.dataset_name, f"data@{self.shared.sample_rate}.parquet"
        )
        os.makedirs(os.path.dirname(self.parquet_path), exist_ok=True)
        self.midi_utils = MidiUtils()
        self.segmenter = Segmenter(self.shared)
        self.chunk_size_bytes = config.chunk_size_mb * 1024 * 1024

    def _estimate_batch_size(self, batch_rows: dict) -> int:
        total = 0
        for key, values in batch_rows.items():
            if not values:
                continue
            if key in ("audio", "notes"):
                total += sum(len(v) for v in values)
            else:
                total += len(values) * 50
        return total

    def _write_chunk(self, batch_rows: dict, chunk_index: int) -> None:
        if not batch_rows or not any(batch_rows.values()):
            return
        pa, pq = pyarrow_modules()
        base_path = self.parquet_path.replace(".parquet", "")
        os.makedirs(base_path, exist_ok=True)
        pq.write_table(pa.table(batch_rows, schema=arrow_schema(pa, self.SCHEMA)),
                       f"{base_path}/{chunk_index:04d}.parquet")
        for key in batch_rows:
            batch_rows[key] = []

    def _read_notes(self, path: str, label_map: dict) -> list:
        """`start label` lines -> [start, start + 0.1, pitch, 100] rows of the
        valid drum pitches, sorted by (onset, offset)."""
        notes = []
        with open(path) as f:
            for line in f:
                content = line.split()
                if content:
                    start, label = content[0], content[1]
                    pitch = label_map[label]
                    if self.midi_utils.valid_note_per_instrument("drums", pitch):
                        notes.append([float(start), float(start) + 0.1, pitch, 100])
        return sorted(notes, key=lambda x: (x[0], x[1]))


class TMIDTTextParser(DrumTextParser):
    """mp3 + `annotations/drums_{m,l}/*.txt` lines `start label` with the
    TMIDT 8-class label map; keeps chunks with notes only."""

    SCHEMA = (("audio_id", "string"), ("audio", "binary"), ("sample_rate", "int32"), ("notes", "binary"))

    def __init__(self, config: TextParserConfig):
        super().__init__(config)
        self.annotation_path = os.path.join(config.dataset_path, "annotations")
        if config.drums_only:
            self.audio_data_files = [f for f in self.audio_data_files if "_accomp" not in f]
        self.audio_data_files = sorted(f for f in self.audio_data_files if os.path.exists(self._annotation_file(f)))
        if config.num_audio_files:
            self.audio_data_files = self.audio_data_files[: config.num_audio_files]

    def _annotation_file(self, audio_file: str) -> str:
        return os.path.join(
            self.annotation_path,
            f"drums_{self.config.dataset_size}",
            Path(audio_file).name.replace(f".{self.config.audio_extension}", ".txt"),
        )

    def parse(self) -> None:
        batch = {"audio_id": [], "audio": [], "sample_rate": [], "notes": []}
        chunk_index = 0
        for audio_file in self.audio_data_files:
            audio_id = Path(audio_file).name
            notes = []
            try:
                # one malformed line (a non-numeric field, an unknown label)
                # skips its file; it must not abort the whole conversion
                with open(self._annotation_file(audio_file)) as f:
                    for line in f:
                        content = line.split()
                        if content:
                            start, label = float(content[0]), int(content[1])
                            notes.append([start, start + 0.1, TMIDT_TO_STANDARD_MIDI[label], 100])
                notes = sorted(notes, key=lambda x: (x[0], x[1]))
                audio = load_and_resample(audio_file, self.shared.sample_rate)
                audio_chunks, notes_chunks = self.segmenter.chunk_audio_and_notes(
                    audio, np.array(notes, dtype=np.float32).reshape(-1, 4)
                )
            except Exception as e:  # an unreadable or inconsistent file is skipped
                logger.warning("skipping %s: %s", audio_file, e)
                continue
            for audio_chunk, notes_chunk in zip(audio_chunks, notes_chunks):
                if not len(notes_chunk):
                    continue
                batch["audio_id"].append(audio_id)
                batch["audio"].append(audio_chunk.astype(np.float32).tobytes())
                batch["sample_rate"].append(self.shared.sample_rate)
                batch["notes"].append(np.asarray(notes_chunk, np.float32).tobytes())
                if self._estimate_batch_size(batch) >= self.chunk_size_bytes:
                    self._write_chunk(batch, chunk_index)
                    chunk_index += 1
        if any(batch.values()):
            self._write_chunk(batch, chunk_index)


class MDBDrumTextParser(DrumTextParser):
    """MDB-Drums: `drum_only` / `demucs_separated` wavs + subclass
    annotations, 3 fixed genre splits, a demucs flag column."""

    SCHEMA = (("audio_id", "string"), ("audio", "binary"), ("sample_rate", "int32"), ("notes", "binary"),
              ("split", "int32"), ("is_demucs_separated", "bool_"))

    def __init__(self, config: TextParserConfig):
        super().__init__(config)
        self.audio_data_files = sorted(
            f for f in self.audio_data_files
            if any(name in f for name in ["drum_only", "demucs_separated"]) and "no_drums" not in f
        )
        self.annotation_path = os.path.join(config.dataset_path, "annotations", "subclass")

    def get_split(self, audio_file: str) -> int:
        for split, genres in MDB_FILE_SPLITS.items():
            if any(genre in audio_file for genre in genres):
                return split
        return -1

    def parse(self) -> None:
        batch = {"audio_id": [], "audio": [], "sample_rate": [], "notes": [], "split": [], "is_demucs_separated": []}
        chunk_index = 0
        for audio_file in self.audio_data_files:
            is_demucs = "_MIX_drums.wav" in audio_file
            audio_id = Path(audio_file).name.replace("_MIX_drums.wav", "_Drum.wav")
            notes = self._read_notes(
                os.path.join(self.annotation_path, audio_id.replace("_Drum.wav", "_subclass.txt")),
                MDB_TO_STANDARD_MIDI)
            audio = load_and_resample(audio_file, self.shared.sample_rate)
            audio_chunks, notes_chunks = self.segmenter.chunk_audio_and_notes(
                audio, np.array(notes, dtype=np.float32).reshape(-1, 4)
            )
            for audio_chunk, notes_chunk in zip(audio_chunks, notes_chunks):
                batch["audio_id"].append(audio_id)
                batch["audio"].append(audio_chunk.astype(np.float32).tobytes())
                batch["sample_rate"].append(self.shared.sample_rate)
                batch["notes"].append(np.asarray(notes_chunk, np.float32).tobytes())
                batch["split"].append(self.get_split(audio_file))
                batch["is_demucs_separated"].append(is_demucs)
                if self._estimate_batch_size(batch) >= self.chunk_size_bytes:
                    self._write_chunk(batch, chunk_index)
                    chunk_index += 1
        if any(batch.values()):
            self._write_chunk(batch, chunk_index)


class ENSTDrumTextParser(DrumTextParser):
    """ENST-Drums: wet_mix wavs + per-drummer annotation txts. The configured
    `chunk_size_mb` sets the flush (the reference pinned 8196 MB); flush
    boundaries change file sizes, never the concatenated rows."""

    SCHEMA = (("audio_id", "string"), ("drummer", "string"), ("audio", "binary"), ("sample_rate", "int32"),
              ("notes", "binary"))

    def __init__(self, config: TextParserConfig):
        super().__init__(config)
        self.audio_data_files = [f for f in self.audio_data_files if "wet_mix" in f]
        if config.drummers:
            names = [f"drummer_{d}" for d in config.drummers]
            self.audio_data_files = [f for f in self.audio_data_files if any(d in f for d in names)]
        self.audio_data_files.sort()

    @staticmethod
    def _path_part(path: str, needle: str) -> str:
        for part in path.split("/"):
            if needle in part:
                return part
        return ""

    def parse(self) -> None:
        batch = {"audio_id": [], "drummer": [], "audio": [], "sample_rate": [], "notes": []}
        chunk_index = 0
        for audio_file in self.audio_data_files:
            drummer = self._path_part(audio_file, "drummer")
            file_name = Path(audio_file).name
            audio_id = f"{drummer}_{file_name}"
            notes = self._read_notes(
                os.path.join(self.config.dataset_path, drummer, "annotation", file_name.replace(".wav", ".txt")),
                ENST_TO_STANDARD_MIDI)
            audio = load_and_resample(audio_file, self.shared.sample_rate)
            try:
                audio_chunks, notes_chunks = self.segmenter.chunk_audio_and_notes(
                    audio, np.array(notes, dtype=np.float32).reshape(-1, 4)
                )
            except ValueError as e:  # annotations past the audio: the file is skipped
                logger.warning("skipping %s: %s", audio_file, e)
                continue
            for audio_chunk, notes_chunk in zip(audio_chunks, notes_chunks):
                batch["audio_id"].append(audio_id)
                batch["drummer"].append(drummer)
                batch["audio"].append(audio_chunk.astype(np.float32).tobytes())
                batch["sample_rate"].append(self.shared.sample_rate)
                batch["notes"].append(np.asarray(notes_chunk, np.float32).tobytes())
                if self._estimate_batch_size(batch) >= self.chunk_size_bytes:
                    self._write_chunk(batch, chunk_index)
                    chunk_index += 1
        if any(batch.values()):
            self._write_chunk(batch, chunk_index)
