"""Augmented tree -> one-shot bank CLI:
`python -m adt_str_tpu_torch.scripts.convert_augmented_to_hdf5 <input_root>
<output_prefix> [--sample_rate 44100] [--overwrite]`.

Port of root `scripts/convert_augmented_to_hdf5.py`; writes
`<output_prefix>@<sample_rate>.hdf5` (needs h5py). The default rate is the
reference CLI's 44100: training opens `<oneshot_path>@<shared.sample_rate>.hdf5`,
so for setting-1 pass `--sample_rate 24000`.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from adt_str_tpu_torch.clap.curation import convert_augmented_to_hdf5
from adt_str_tpu_torch.utils.misc import setup_logging


def main(argv: list[str] | None = None) -> Path:
    parser = argparse.ArgumentParser()
    parser.add_argument("input_root", type=str)
    parser.add_argument("output_hdf5", type=str)
    parser.add_argument("--sample_rate", type=int, default=44100)
    parser.add_argument("--overwrite", action="store_true")
    args = parser.parse_args(argv)
    setup_logging()
    return convert_augmented_to_hdf5(args.input_root, args.output_hdf5, args.sample_rate, args.overwrite)


if __name__ == "__main__":
    main()
