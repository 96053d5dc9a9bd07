"""Evaluation harness: batched greedy or beam decode -> notes -> onset F-measure.

Port of `adt_str_tpu/evaluation/harness.py:run_inference` on one device:

- batches whose longest wave is under 1024 samples are skipped;
- each batch is zero-padded to `chunk_samples`, and a ragged batch gets
  silent rows up to `batch_size`, so the decode batch is the JAX package's;
- per item: truncation at the first EOS or PAD, decode, the velocity >= 0
  filter and row dedup (`evaluation/notes.py`), notes in float64;
- aggregate and per-ADTOF-label TP/FN/FP, and the drum confusion matrix
  (ADTOF classes or the GM names, by tokenizer mode), written every 50
  items and at the end as `confusion_matrix.csv`, with `metrics.json`, to
  `inference.output_path`; `max_samples` stops after the batch that reaches
  it.

`inference.use_beam_search` decodes with `beam_search_decode`
(`beam_size`, 5 when unset; length penalty 1.0), as the JAX harness does.

With a `mesh` (`parallel/mesh.py:DataMesh`) the decode runs data-parallel,
as at `adt_str_tpu/evaluation/harness.py:115-140`: the decode batch is
rounded up to the data axis, and each mesh entry decodes its own rows
(`models/decode.py`'s sharded decoders). In a process group every rank
walks the same dataset, decodes its row stripe of each global batch, and
the tokens are all-gathered to every rank (through host memory with
gloo), so every rank computes the same metrics; rank 0 alone writes
`output_path`.
"""

from __future__ import annotations

import json
import logging
import os
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from adt_str_tpu_torch import resolve_device
from adt_str_tpu_torch.config import InferenceConfig, ModelConfig
from adt_str_tpu_torch.domain.tokenizer import MidiTokenizer
from adt_str_tpu_torch.evaluation.confusion import DrumConfusionMatrix
from adt_str_tpu_torch.evaluation.metrics import (
    aggregate_metrics,
    compute_metrics,
    compute_per_label_metrics,
    new_per_label_accumulator,
)
from adt_str_tpu_torch.evaluation.notes import decode_tokens_to_notes
from adt_str_tpu_torch.models.adt import ADTModel
from adt_str_tpu_torch.models.decode import (
    beam_search_decode,
    beam_search_decode_sharded,
    greedy_decode,
    greedy_decode_sharded,
)
from adt_str_tpu_torch.parallel.mesh import DataMesh
from adt_str_tpu_torch.utils.mappings import ADTOF_LABEL_MAPPING, GM_REDUCED_NAME_CONVENTION

logger = logging.getLogger(__name__)


def _pad_batch(wavs: list[np.ndarray], chunk_samples: int) -> np.ndarray:
    out = np.zeros((len(wavs), chunk_samples), dtype=np.float32)
    for i, w in enumerate(wavs):
        n = min(len(w), chunk_samples)
        out[i, :n] = w[:n]
    return out


def _decoder(cfg: InferenceConfig, max_len: int, bos: int, eos: int, mesh: Optional[DataMesh]):
    """-> `decode(model, wavs) -> tokens`: greedy or beam, sharded over
    `mesh` when there is one."""
    if cfg.use_beam_search:
        kw = dict(max_length=max_len, beam_size=cfg.beam_size or 5, start_token=bos, end_token=eos)
        if mesh is not None:
            return lambda m, w: beam_search_decode_sharded(m, w, mesh, **kw)
        return lambda m, w: beam_search_decode(m, w, **kw)
    kw = dict(max_length=max_len, start_token=bos, end_token=eos)
    if mesh is not None:
        return lambda m, w: greedy_decode_sharded(m, w, mesh, **kw)
    return lambda m, w: greedy_decode(m, w, **kw)


def run_inference(
    model: ADTModel,
    model_config: ModelConfig,
    dataset,
    tokenizer: MidiTokenizer,
    inference_config: InferenceConfig,
    exclude_ref_empty: bool = False,
    device=None,
    mesh: Optional[DataMesh] = None,
) -> dict:
    """Decode every batch of `dataset.batches(batch_size)` ({"wavs": [1-D
    float arrays], "notes": [(n, 4) arrays]}) with `model` on `device`
    (None: cuda, or the mesh's first device) -> {"all": {precision,
    recall, f_measure}, "<label>": {...}}; over `mesh` as the module
    docstring says."""
    cfg = inference_config
    batch_rows = cfg.batch_size
    writer = True
    if mesh is not None:
        batch_rows = -(-cfg.batch_size // mesh.n_data) * mesh.n_data  # rows divisible by the data axis
        device = mesh.device if device is None else device
        writer = mesh.rank == 0
    device = resolve_device(device)
    model = model.to(device).eval()
    decode = _decoder(cfg, max(2, int(cfg.max_length)), tokenizer.BOS_token, tokenizer.EOS_token, mesh)
    TP = FN = FP = 0
    per_label = new_per_label_accumulator()
    confusion = DrumConfusionMatrix(ADTOF_LABEL_MAPPING if tokenizer.ADTOF_mapping else GM_REDUCED_NAME_CONVENTION)
    output_path = cfg.output_path if writer else ""
    if output_path:
        os.makedirs(output_path, exist_ok=True)

    n_items = 0
    for batch in dataset.batches(cfg.batch_size):
        gt_notes, raw_wavs = batch["notes"], batch["wavs"]
        if max(len(w) for w in raw_wavs) < 1024:
            continue
        n_real = len(raw_wavs)
        if n_real < batch_rows:
            raw_wavs = list(raw_wavs) + [np.zeros(1024, np.float32)] * (batch_rows - n_real)
        wavs = torch.from_numpy(_pad_batch(raw_wavs, model_config.chunk_samples))
        if mesh is not None and mesh.world > 1:  # this rank's stripe, then every rank's tokens
            tokens_pred = mesh.all_gather_rows(decode(model, wavs[mesh.local_rows(batch_rows)].to(device)))
        else:
            tokens_pred = decode(model, wavs.to(device))
        tokens_pred = tokens_pred.cpu().numpy()

        for i in range(n_real):
            gt = np.asarray(gt_notes[i]).reshape(-1, 4) if len(gt_notes[i]) else []
            pred_notes = decode_tokens_to_notes(tokenizer, tokens_pred[i])
            tp, fn, fp = compute_metrics(gt, pred_notes, exclude_ref_empty)
            TP += tp
            FN += fn
            FP += fp
            per_label = compute_per_label_metrics(pred_notes, gt, per_label, exclude_ref_empty)
            confusion.update(gt, pred_notes, exclude_ref_empty=exclude_ref_empty)
            n_items += 1
            if output_path and n_items % 50 == 0:
                confusion.to_csv(os.path.join(output_path, "confusion_matrix.csv"))
        if cfg.max_samples and n_items >= cfg.max_samples:
            break

    combined: dict = defaultdict(dict)
    combined["all"].update(aggregate_metrics(TP, FN, FP))
    for label, m in per_label.items():
        combined[label].update(aggregate_metrics(m["tp"], m["fn"], m["fp"]))

    if output_path:
        confusion.to_csv(os.path.join(output_path, "confusion_matrix.csv"))
        with open(os.path.join(output_path, "metrics.json"), "w") as f:
            json.dump(combined, f)
    logger.info("eval items=%d TP=%d FN=%d FP=%d", n_items, TP, FN, FP)
    return dict(combined)
