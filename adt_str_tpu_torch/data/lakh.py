"""Lakh MIDI -> drum-note parquet shards.

Port of `adt_str_tpu/data/lakh.py` (its own copy): walks `lmd_matched`-style
A-Z partitions, keeps drum instruments (channel 10) only, notes as
[start, start + 0.1, pitch, velocity] with pitch validity 35-81, sorts by
(onset, offset), segments with the `Segmenter` (dropping chunk-straddling
notes), and writes one parquet per partition with schema (midi_id: string,
segment_number: int32, notes: binary float32 rows).

Parallelism: an optional process pool (`n_jobs > 1`, spawned workers);
host-side preprocessing that launches no kernel. pyarrow is imported where
the shards are written (`parsers.pyarrow_modules`).
"""

from __future__ import annotations

import logging
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

from adt_str_tpu_torch.config import SharedConfig
from adt_str_tpu_torch.data.parsers import arrow_schema, pyarrow_modules
from adt_str_tpu_torch.domain.segmenter import Segmenter
from adt_str_tpu_torch.utils.midi_io import read_midi
from adt_str_tpu_torch.utils.midi_utils import MidiUtils

logger = logging.getLogger(__name__)

SCHEMA = (("midi_id", "string"), ("segment_number", "int32"), ("notes", "binary"))
PARTITIONS = [chr(c) for c in range(ord("A"), ord("Z") + 1)]


class LakhMidiParser:
    def __init__(
        self,
        midi_root: str,
        dump_path: str,
        shared: SharedConfig,
        partitions: list[str] | None = None,
        n_jobs: int = 1,
        dataset_name: str = "lakh_matched",
    ):
        partitions = PARTITIONS if partitions is None else partitions
        bad = [p for p in partitions if p not in PARTITIONS]
        if bad:
            raise ValueError(f"Lakh partitions are single letters A-Z, got {bad}")
        self.midi_root = midi_root
        self.dump_path = os.path.join(dump_path, dataset_name)
        os.makedirs(self.dump_path, exist_ok=True)
        self.partitions = partitions
        self.n_jobs = n_jobs
        self.midi_utils = MidiUtils()
        self.segmenter = Segmenter(shared)

    def parse_midi(self, midi_file: Path) -> dict | None:
        """One MIDI file -> its rows, or None when it cannot be parsed (such
        files are skipped, as the reference skips them)."""
        try:
            instruments = read_midi(midi_file)
        except Exception as e:  # a corrupt file of the corpus must not stop the partition
            logger.debug("skipping %s: %s", midi_file, e)
            return None
        rows = {"midi_id": [], "segment_number": [], "notes": []}
        for inst in instruments:
            if not inst.is_drum:
                continue
            notes = [
                [n[0], n[0] + 0.1, n[2], n[3]]
                for n in inst.notes
                if self.midi_utils.valid_note_per_instrument("drums", int(n[2]))
            ]
            notes = sorted(notes, key=lambda x: (x[0], x[1]))
            if not notes:
                continue
            for i, chunk in enumerate(self.segmenter.chunk_notes(np.array(notes))):
                if len(chunk):
                    rows["midi_id"].append(midi_file.stem)
                    rows["segment_number"].append(i)
                    rows["notes"].append(np.asarray(chunk, dtype=np.float32).tobytes())
        return rows

    def process_partition(self, partition: str) -> str:
        pa, pq = pyarrow_modules()
        midi_files = sorted(Path(os.path.join(self.midi_root, partition)).rglob("*.mid"))
        batch = {"midi_id": [], "segment_number": [], "notes": []}
        if self.n_jobs > 1:
            with ProcessPoolExecutor(max_workers=self.n_jobs, mp_context=multiprocessing.get_context("spawn")) as ex:
                results = list(ex.map(self.parse_midi, midi_files))
        else:
            results = [self.parse_midi(f) for f in midi_files]
        for rows in results:
            if rows:
                for k in batch:
                    batch[k].extend(rows[k])
        out = os.path.join(self.dump_path, f"{partition}.parquet")
        pq.write_table(pa.table(batch, schema=arrow_schema(pa, SCHEMA)), out)
        return out

    def create_dataset(self) -> list[str]:
        return [self.process_partition(p) for p in self.partitions]
