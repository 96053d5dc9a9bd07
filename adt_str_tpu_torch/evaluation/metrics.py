"""Transcription metrics: per-item TP/FN/FP and aggregate P/R/F.

Port of `adt_str_tpu/evaluation/metrics.py` (its own copy): onset-only
matching at 0.05 s, pitches scaled x1000 against a 1-cent tolerance (exact
pitch), the empty-reference and empty-estimate cases, `exclude_ref_empty`
suppressing false positives on items whose reference is empty, and per-label
counts over the ADTOF classes without "Other".
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from adt_str_tpu_torch.ops.matching import match_notes
from adt_str_tpu_torch.utils.mappings import ADTOF_LABEL_MAPPING


def _rows(notes, dtype=None) -> np.ndarray:
    return np.asarray(notes, dtype=dtype).reshape(-1, 4) if len(notes) else np.zeros((0, 4))


def compute_metrics(ref_notes, est_notes, exclude_ref_empty: bool = False) -> tuple[int, int, int]:
    """-> (TP, FN, FP) for one item."""
    ref_notes, est_notes = _rows(ref_notes, np.float64), _rows(est_notes, np.float64)
    if len(ref_notes) == 0 and len(est_notes) == 0:
        return 0, 0, 0
    if len(ref_notes) == 0:
        return 0, 0, (len(est_notes) if not exclude_ref_empty else 0)
    if len(est_notes) == 0:
        return 0, len(ref_notes), 0
    matching = match_notes(
        ref_notes[:, 0:2], ref_notes[:, 2] * 1000, est_notes[:, 0:2], est_notes[:, 2] * 1000,
        onset_tolerance=0.05, offset_ratio=None, pitch_tolerance=1.0,
    )
    tp = len(matching)
    return tp, len(ref_notes) - tp, len(est_notes) - tp


def compute_per_label_metrics(pred_notes, gt_notes, per_label_metrics: dict, exclude_ref_empty: bool = False) -> dict:
    """Accumulate per-ADTOF-class TP/FN/FP into `per_label_metrics`. False
    positives are suppressed only when the whole reference is empty. The
    ADTOF class table is used whatever the tokenizer mode, as in the
    reference: with a GM-mode tokenizer, GM-custom pitches outside the ADTOF
    classes fall out of every bucket."""
    exclude_fp_for_slices = exclude_ref_empty and len(gt_notes) == 0
    pred_notes, gt_notes = _rows(pred_notes), _rows(gt_notes)
    for pitch, label in ADTOF_LABEL_MAPPING.items():
        if label == "Other":
            continue
        pred_label = pred_notes[pred_notes[:, 2] == pitch] if len(pred_notes) else []
        gt_label = gt_notes[gt_notes[:, 2] == pitch] if len(gt_notes) else []
        tp, fn, fp = compute_metrics(gt_label, pred_label, exclude_fp_for_slices)
        per_label_metrics[label]["tp"] += tp
        per_label_metrics[label]["fn"] += fn
        per_label_metrics[label]["fp"] += fp
    return per_label_metrics


def aggregate_metrics(tp: int, fn: int, fp: int) -> dict[str, float]:
    precision = tp / (tp + fp) if (tp + fp) else 0.0
    recall = tp / (tp + fn) if (tp + fn) else 0.0
    f_measure = 2 * precision * recall / (precision + recall) if (precision + recall) else 0.0
    return {"precision": precision, "recall": recall, "f_measure": f_measure}


def new_per_label_accumulator() -> dict:
    return defaultdict(lambda: defaultdict(int))
