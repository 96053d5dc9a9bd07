"""Drum confusion matrix of an evaluation.

Port of `adt_str_tpu/evaluation/confusion.py:DrumConfusionMatrix` without
pandas, which the machine with the card lacks: the counts are a plain
integer table, and `to_csv` writes the bytes that the JAX class's
`DataFrame.to_csv` writes (an empty first header cell, int counts, `repr`
floats, empty cells in the "False Positive" row's metric columns, "\\n"
line ends, a field quoted only when it holds a comma, a quote or a line
break).

Matching is greedy in two passes within the onset tolerance: exact-pitch
pairs, globally closest first; then each remaining reference note takes its
closest unmatched candidate of any pitch (a confusion cell). Unmatched
reference notes count in the "False Negative" column, unmatched
predictions in the "False Positive" row (not when `exclude_ref_empty` is
set and the reference is empty).
"""

from __future__ import annotations

import csv

import numpy as np


class DrumConfusionMatrix:
    def __init__(self, label_mapping: dict[int, str], onset_tolerance: float = 0.05):
        base = list(label_mapping.values())
        if "Other" not in base:
            base.append("Other")
        self.labels = base
        self.mapping = label_mapping
        self.onset_tolerance = onset_tolerance
        self.rows = self.labels + ["False Positive"]
        self.columns = self.labels + ["False Negative"]
        self.counts = {r: dict.fromkeys(self.columns, 0) for r in self.rows}

    def _label(self, pitch) -> str:
        return self.mapping.get(int(pitch), "Other")

    def update(self, ref_notes, pred_notes, exclude_ref_empty: bool = False) -> None:
        refs = [(i, float(r[0]), int(r[2])) for i, r in enumerate(ref_notes)]
        preds = [(j, float(p[0]), int(p[2])) for j, p in enumerate(pred_notes)]
        cand = {
            i: sorted((abs(p_on - r_on), j) for j, p_on, _ in preds if abs(p_on - r_on) <= self.onset_tolerance)
            for i, r_on, _ in refs
        }
        matched_ref: dict[int, int] = {}
        matched_pred: dict[int, int] = {}

        # pass 1: exact-pitch matches, globally closest first
        exact_edges = [(dt, i, j) for i, _, r_pi in refs for dt, j in cand[i] if preds[j][2] == r_pi]
        exact_edges.sort(key=lambda x: x[0])
        for _, i, j in exact_edges:
            if i not in matched_ref and j not in matched_pred:
                matched_ref[i] = j
                matched_pred[j] = i

        # pass 2: remaining refs -> closest unmatched candidate (confusions)
        for i, _, _ in refs:
            if i in matched_ref:
                continue
            for _, j in cand[i]:
                if j not in matched_pred:
                    matched_ref[i] = j
                    matched_pred[j] = i
                    break

        for i, _, r_pi in refs:
            column = self._label(preds[matched_ref[i]][2]) if i in matched_ref else "False Negative"
            self.counts[self._label(r_pi)][column] += 1
        if not (exclude_ref_empty and len(refs) == 0):
            for j, _, p_pi in preds:
                if j not in matched_pred:
                    self.counts["False Positive"][self._label(p_pi)] += 1

    def _metrics_for_label(self, lbl: str) -> tuple[float, float, float, int]:
        c = self.counts
        tp = c[lbl][lbl]
        fn = c[lbl]["False Negative"] + sum(c[lbl][other] for other in self.labels) - tp
        fp = c["False Positive"][lbl] + sum(c[other][lbl] for other in self.labels) - tp
        prec = tp / (tp + fp) if (tp + fp) else 0.0
        rec = tp / (tp + fn) if (tp + fn) else 0.0
        f1 = (2 * prec * rec / (prec + rec)) if (prec + rec) else 0.0
        return prec, rec, f1, tp + fn

    def to_csv(self, path: str) -> None:
        """The counts with per-label precision, recall, f1 and support
        columns; the "False Positive" row has empty metric cells."""
        with open(path, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(["", *self.columns, "precision", "recall", "f1", "support"])
            for row in self.rows:
                metrics = self._metrics_for_label(row) if row in self.labels else ("",) * 4
                writer.writerow([row, *(self.counts[row][c] for c in self.columns), *metrics])

    def get_matrix(self) -> tuple[list[str], list[str], np.ndarray]:
        """-> (row labels, column labels, int64 counts of shape (rows,
        columns)): the JAX class's `get_matrix()` DataFrame as
        `(list(df.index), list(df.columns), df.values)`; rows are the labels
        and "False Positive", columns the labels and "False Negative"."""
        counts = np.array([[self.counts[r][c] for c in self.columns] for r in self.rows], dtype=np.int64)
        return list(self.rows), list(self.columns), counts
