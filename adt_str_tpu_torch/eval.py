"""Evaluation CLI:
`python -m adt_str_tpu_torch.eval <config.yaml> [-e] [--device D]`.

Port of the root `eval.py`: the merged YAML names the reference-format
checkpoint (`inference.checkpoint_path`), the ENST or MDB parquet shards
and their filters (`EvalDatasetConfig`), and the output directory
(`inference.output_path`), where `metrics.json` and `confusion_matrix.csv`
are written. `-e/--exclude_ref_empty` drops false positives on items whose
reference is empty. Runs on cuda unless `--device` names another device.
Reading the shards needs pyarrow.

Data-parallel decode, as root `eval.py:36-76`: under torchrun (`python -m
torch.distributed.run --nproc_per_node N -m adt_str_tpu_torch.eval ...`)
each rank decodes its stripe of every batch on its device
(`parallel/mesh.py:placement`) and every rank gets the same metrics; in
one process with no `--device` and more than one visible card, the
batches split over all of them.
"""

from __future__ import annotations

import argparse
import logging

import torch

from adt_str_tpu_torch import resolve_device
from adt_str_tpu_torch.config import FrameworkConfig
from adt_str_tpu_torch.data.datasets import ENSTDataset, MDBDataset
from adt_str_tpu_torch.domain.tokenizer import MidiTokenizer
from adt_str_tpu_torch.evaluation.harness import run_inference
from adt_str_tpu_torch.models.adt import ADTModel
from adt_str_tpu_torch.models.convert import load_reference_checkpoint
from adt_str_tpu_torch.parallel import mesh as mesh_lib

logger = logging.getLogger(__name__)

DATASETS = {"ENST": ENSTDataset, "MDB": MDBDataset}


def main(cfg: FrameworkConfig, exclude_ref_empty: bool = False, device=None) -> dict:
    logging.basicConfig(level=(cfg.raw.get("logging") or {}).get("log_level", "INFO"),
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    joined = mesh_lib.maybe_initialize_distributed(device)
    try:
        return _evaluate(cfg, exclude_ref_empty, device if joined is None else joined)
    finally:
        if joined is not None:
            mesh_lib.destroy()


def _evaluate(cfg: FrameworkConfig, exclude_ref_empty: bool, device) -> dict:
    checkpoint_path = cfg.inference.checkpoint_path
    if not checkpoint_path:
        raise ValueError("inference.checkpoint_path is required")
    if cfg.eval_data is None:
        raise ValueError("an EvalDatasetConfig section is required")
    if cfg.eval_data.dataset_name not in DATASETS:
        raise ValueError(f"Dataset name {cfg.eval_data.dataset_name} not supported")
    mesh = None
    if torch.distributed.is_initialized() and torch.distributed.get_world_size() > 1:
        mesh = mesh_lib.make_mesh(devices=[resolve_device(device)])
    elif device is None and torch.cuda.device_count() > 1:
        mesh = mesh_lib.make_mesh()
    if mesh is not None:
        device = mesh.device
        logger.info("sharding eval decode over %d devices (%d processes)", mesh.n_data, mesh.world)
    device = resolve_device(device)

    logger.info("Loading model from checkpoint: %s", checkpoint_path)
    model = ADTModel(cfg.model, device=device)
    model.load_state_dict(load_reference_checkpoint(checkpoint_path, device), strict=True)
    tokenizer = MidiTokenizer(cfg.tokenizer)
    dataset = DATASETS[cfg.eval_data.dataset_name](cfg.eval_data, tokenizer)
    logger.info("Dataset size: %d", len(dataset))

    metrics = run_inference(model, cfg.model, dataset, tokenizer, cfg.inference,
                            exclude_ref_empty=exclude_ref_empty, device=device, mesh=mesh)
    logger.info("=" * 50)
    logger.info("RESULTS:")
    logger.info("Precision: %.4f", metrics["all"]["precision"])
    logger.info("Recall:    %.4f", metrics["all"]["recall"])
    logger.info("F1-Score:  %.4f", metrics["all"]["f_measure"])
    return metrics


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="ADT evaluation on ENST or MDB")
    parser.add_argument("config", type=str, help="Path to config file")
    parser.add_argument("-e", "--exclude_ref_empty", action="store_true",
                        help="Exclude false positives when reference is empty")
    parser.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = parser.parse_args()
    main(FrameworkConfig.from_yaml(args.config), exclude_ref_empty=args.exclude_ref_empty, device=args.device)
