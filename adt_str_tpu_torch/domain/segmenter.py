"""Audio and note chunkers.

Port of `adt_str_tpu/domain/segmenter.py`: `chunk_wave` and the note side of
`Segmenter` (`chunk_notes`, which the resynthesis of a transcription
uses; `chunk_audio_and_notes` joins with the training data slice). Notes
whose onset and offset land in different chunks are dropped, as in the
reference, and onset and offset are re-based modulo the chunk length.
"""

from __future__ import annotations

import numpy as np

from adt_str_tpu_torch.config import SharedConfig


class Segmenter:
    def __init__(self, config: SharedConfig):
        self.config = config

    def _assign(self, notes: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-note chunk index, whether the note lies in one chunk, and the
        re-based [onset, offset, pitch, velocity] rows."""
        sec = self.config.input_sec
        onset, offset = notes[:, 0], notes[:, 1]
        on_idx = (onset // sec).astype(np.int64)
        keep = on_idx == (offset // sec).astype(np.int64)
        rebased = notes.copy()
        rebased[:, 0] = onset % sec
        rebased[:, 1] = offset % sec
        return on_idx, keep, rebased

    def chunk_notes(self, notes: np.ndarray) -> list[np.ndarray]:
        """A note list -> one float32 (n, 4) array per `input_sec` chunk,
        `max offset // input_sec + 1` chunks."""
        notes = np.asarray(notes, dtype=np.float32)
        n_chunks = int(notes[:, 1].max() // self.config.input_sec) + 1
        on_idx, keep, rebased = self._assign(notes)
        return [rebased[keep & (on_idx == c)].reshape(-1, 4) for c in range(n_chunks)]


def chunk_wave(
    wave: np.ndarray, chunk_samples: int, hop_samples: int | None = None
) -> list[tuple[int, np.ndarray, int]]:
    """1-D wave -> [(start_sample, chunk, true_len)].

    Every chunk is zero-padded to `chunk_samples`; `hop_samples` <
    `chunk_samples` gives overlapping chunks; `true_len` is the pre-pad
    sample count. An empty wave yields one silent chunk (a transcription
    request always decodes at least once)."""
    wave = np.asarray(wave, dtype=np.float32).reshape(-1)
    hop = hop_samples or chunk_samples
    out: list[tuple[int, np.ndarray, int]] = []
    start = 0
    n = len(wave)
    while start < n:
        piece = wave[start : start + chunk_samples]
        true_len = len(piece)
        if true_len < chunk_samples:
            piece = np.pad(piece, (0, chunk_samples - true_len))
        out.append((start, piece, true_len))
        start += hop
    if not out:
        out.append((0, np.zeros(chunk_samples, np.float32), 0))
    return out
