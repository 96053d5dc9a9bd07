"""CLAP curation CLI:
`python -m adt_str_tpu_torch.scripts.augment_data_with_clap <config.yaml> [--num_bins N] [--device D]`.

Port of root `scripts/augment_data_with_clap.py`: the YAML (deep-merged
over `configs/config_default.yaml`) names the local CLAP checkpoint
directory, the batch size and the two trees (`clap_config`, e.g.
`configs/preprocess/clap.yaml` with `CLAP_MODEL_DIR` and `ADT_DATA` set),
and the library is curated into `<reference_root>_clap_augmented`.
`--num_bins` is checked before the model loads. Runs on cuda unless
`--device` names another device.

Under torchrun (`python -m torch.distributed.run --nproc_per_node N -m
adt_str_tpu_torch.scripts.augment_data_with_clap ...`) each rank encodes a
stripe of the files on its device (`parallel/mesh.py:placement`) and rank 0
writes the tree; in one process with no `--device` and more than one
visible card, every batch splits over all of them.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch
import torch.distributed as dist

from adt_str_tpu_torch import resolve_device
from adt_str_tpu_torch.clap.curation import curate_library, validate_num_bins
from adt_str_tpu_torch.clap.model import ClapWrapper
from adt_str_tpu_torch.config import ClapConfig, load_merged_config, make_dataclass_from
from adt_str_tpu_torch.parallel import mesh as mesh_lib
from adt_str_tpu_torch.utils.misc import setup_logging


def main(argv: list[str] | None = None) -> Path:
    parser = argparse.ArgumentParser(description="Curate a one-shot library by CLAP similarity")
    parser.add_argument("config_path", type=str)
    parser.add_argument("--num_bins", type=int, default=10)
    parser.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    try:  # before the CLAP model loads
        validate_num_bins(args.num_bins)
    except ValueError as e:
        parser.error(str(e))

    setup_logging()
    cfg = load_merged_config(args.config_path)
    clap_cfg = make_dataclass_from(ClapConfig, cfg.get("clap_config", {}), cfg.get("shared", {}))
    joined = mesh_lib.maybe_initialize_distributed(args.device)
    try:
        device = args.device if joined is None else joined
        mesh = None
        if dist.is_initialized() and dist.get_world_size() > 1:
            mesh = mesh_lib.make_mesh(devices=[resolve_device(device)])
        elif device is None and torch.cuda.device_count() > 1:
            mesh = mesh_lib.make_mesh()
        if mesh is not None:
            device = mesh.device
        # the tower shapes come from the checkpoint's config.json
        wrapper = ClapWrapper.from_dir(clap_cfg.model_name, sample_rate=clap_cfg.sample_rate, device=device)
        return curate_library(wrapper, clap_cfg.sample_pack_root, clap_cfg.reference_root,
                              sample_rate=clap_cfg.sample_rate, batch_size=clap_cfg.batch_size,
                              num_bins=args.num_bins, mesh=mesh)
    finally:
        if joined is not None:
            mesh_lib.destroy()


if __name__ == "__main__":
    main()
