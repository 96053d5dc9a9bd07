"""Tokens -> notes and the chunk merge.

Port of `adt_str_tpu/evaluation/harness.py:decode_tokens_to_notes` and
`merge_chunk_notes` (the metric harness joins with the eval slice). Notes
stay float64 throughout, as in the JAX package: float32 onsets flip
matches at |dt| == 0.05 boundaries.
"""

from __future__ import annotations

import numpy as np

from adt_str_tpu_torch.domain.tokenizer import MidiTokenizer


def decode_tokens_to_notes(tokenizer: MidiTokenizer, pred_tokens: np.ndarray) -> np.ndarray:
    """EOS/PAD truncation + decode + velocity >= 0 filter + row dedup."""
    pred_tokens = tokenizer.truncate_at_eos(pred_tokens)
    pred_notes = tokenizer.decode(pred_tokens)
    if pred_notes.size:
        pred_notes = pred_notes[pred_notes[:, 3] >= 0]
        pred_notes = np.unique(pred_notes, axis=0)
    return pred_notes.reshape(-1, 4) if pred_notes.size else np.zeros((0, 4), np.float64)


def merge_chunk_notes(all_notes: list, snap_to_grid: bool = False) -> np.ndarray:
    """Concatenate per-chunk time-shifted note arrays and row-dedup.

    `snap_to_grid` (overlap-hop mode only) re-quantizes shifted times to one
    float per 10 ms grid point before the dedup: `k*0.01 + chunk_start` from
    different (k, start) pairs for the same absolute time can differ by an
    ulp, and exact-equality dedup would keep both."""
    if not all_notes:
        return np.zeros((0, 4), dtype=np.float64)
    notes = np.concatenate(all_notes, axis=0).astype(np.float64, copy=False)
    if snap_to_grid:
        notes[:, 0:2] = np.round(notes[:, 0:2] * 100.0) / 100.0
    return np.unique(notes, axis=0)
