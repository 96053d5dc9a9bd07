"""Training CLI: `python -m adt_str_tpu_torch.train <experiment.yaml> [--device D]`.

Port of the root `train.py`: one positional experiment YAML, deep-merged
over `configs/config_default.yaml`, drives `training/trainer.py:train`.
Runs on cuda unless `--device` names another device. The shards are read
with pyarrow and a Lakh run's one-shot bank with h5py.

Data-parallel: `python -m torch.distributed.run --nproc_per_node N -m
adt_str_tpu_torch.train <yaml>` (or `torchrun`) trains over N ranks, each
on a card of its own with NCCL; `--device cuda:0` puts every rank on that
card and `--device cpu` on the CPU, both with gloo
(`parallel/mesh.py:placement`). Without torchrun's environment it trains
in one process.
"""

from __future__ import annotations

import argparse

from adt_str_tpu_torch.config import FrameworkConfig
from adt_str_tpu_torch.training.trainer import train


def main(argv=None):
    parser = argparse.ArgumentParser(description="ADT training on one GPU, or data-parallel under torchrun")
    parser.add_argument("config", type=str)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; under torchrun a card a rank)")
    args = parser.parse_args(argv)
    return train(FrameworkConfig.from_yaml(args.config), device=args.device)


if __name__ == "__main__":
    main()
