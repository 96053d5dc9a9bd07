"""Audio chunker for transcription.

Port of `adt_str_tpu/domain/segmenter.py:chunk_wave` (the note-aware
`Segmenter` joins with the data slice).
"""

from __future__ import annotations

import numpy as np


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
