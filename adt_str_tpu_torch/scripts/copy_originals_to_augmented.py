"""Gold-bin CLI: `python -m adt_str_tpu_torch.scripts.copy_originals_to_augmented
<reference_root> [--augmented_root PATH]`.

Port of root `scripts/copy_originals_to_augmented.py`: copies the
hand-curated reference WAVs into `<class>/gold/` of the augmented tree
(default `<reference_root>_clap_augmented`).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from adt_str_tpu_torch.clap.curation import copy_originals_to_augmented


def main(argv: list[str] | None = None) -> Path:
    parser = argparse.ArgumentParser()
    parser.add_argument("reference_root", type=str)
    parser.add_argument("--augmented_root", type=str, default=None)
    args = parser.parse_args(argv)
    return copy_originals_to_augmented(args.reference_root, args.augmented_root)


if __name__ == "__main__":
    main()
