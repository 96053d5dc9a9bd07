"""Training CLI on one GPU:
`python -m adt_str_tpu_torch.train <experiment.yaml> [--device D]`.

Port of the root `train.py`: one positional experiment YAML, deep-merged
over `configs/config_default.yaml`, drives `training/trainer.py:train`.
Runs on cuda unless `--device` names another device. The shards are read
with pyarrow and a Lakh run's one-shot bank with h5py.
"""

from __future__ import annotations

import argparse

from adt_str_tpu_torch.config import FrameworkConfig
from adt_str_tpu_torch.training.trainer import train


def main(argv=None):
    parser = argparse.ArgumentParser(description="ADT training on one GPU")
    parser.add_argument("config", type=str)
    parser.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    return train(FrameworkConfig.from_yaml(args.config), device=args.device)


if __name__ == "__main__":
    main()
