"""Lakh MIDI -> parquet CLI: `python -m adt_str_tpu_torch.scripts.midi_parser <config.yaml>`.

Port of root `scripts/midi_parser.py`: the YAML (deep-merged over
`configs/config_default.yaml`, `${oc.env:ADT_DATA}` resolved), e.g.
`configs/preprocess/make_dataset.yaml`, names the `preprocess` section's
`midi_root`, `dump_path`, `partitions`, `n_jobs` and `dataset_name` and the
`shared` framing; one shard a partition goes to
`<dump_path>/<dataset_name>/<letter>.parquet`. Host-only (no kernel); it
needs pyarrow.
"""

from __future__ import annotations

import argparse

from adt_str_tpu_torch.config import SharedConfig, load_merged_config, make_dataclass_from
from adt_str_tpu_torch.data.lakh import LakhMidiParser
from adt_str_tpu_torch.utils.misc import setup_logging


def main(argv: list[str] | None = None) -> list[str]:
    parser = argparse.ArgumentParser(description="Lakh MIDI drum notes -> parquet shards")
    parser.add_argument("config_path", type=str)
    args = parser.parse_args(argv)
    setup_logging()
    cfg = load_merged_config(args.config_path)
    pre = cfg.get("preprocess", {})
    shared = make_dataclass_from(SharedConfig, cfg.get("shared", {}))
    return LakhMidiParser(
        midi_root=pre["midi_root"],
        dump_path=pre["dump_path"],
        shared=shared,
        partitions=pre.get("partitions"),
        n_jobs=int(pre.get("n_jobs", 1) or 1),
        dataset_name=pre.get("dataset_name", "lakh_matched"),
    ).create_dataset()


if __name__ == "__main__":
    main()
