"""Eval and train set text parser CLI:
`python -m adt_str_tpu_torch.scripts.text_parser <config.yaml>`.

Port of root `scripts/text_parser.py`: the YAML (deep-merged over
`configs/config_default.yaml`, `${oc.env:ADT_DATA}` resolved), e.g.
`configs/preprocess/{ENST_preprocess,MDB_preprocess,TMIDT}.yaml`, names the
`EvalDataPreprocess` section (`dataset_name` ENST, MDB or TMIDT selects the
parser) and the `shared` framing; shards go to
`<output_path>/<dataset_name>/data@<sr>/NNNN.parquet`. Host-only (no
kernel); it needs pyarrow.
"""

from __future__ import annotations

import argparse

from adt_str_tpu_torch.config import SharedConfig, load_merged_config, make_dataclass_from
from adt_str_tpu_torch.data.parsers import ENSTDrumTextParser, MDBDrumTextParser, TextParserConfig, TMIDTTextParser
from adt_str_tpu_torch.utils.misc import setup_logging

PARSERS = {"ENST": ENSTDrumTextParser, "MDB": MDBDrumTextParser, "TMIDT": TMIDTTextParser}


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="ENST / MDB / TMIDT annotations + audio -> parquet shards")
    parser.add_argument("config_path", type=str)
    args = parser.parse_args(argv)
    setup_logging()
    cfg = load_merged_config(args.config_path)
    section = cfg.get("EvalDataPreprocess", {})
    name = section["dataset_name"]
    if name not in PARSERS:
        raise ValueError(f"Dataset name {name} not supported")
    pcfg = TextParserConfig(
        dataset_path=section["dataset_path"],
        output_path=section["output_path"],
        dataset_name=name,
        audio_extension=section.get("audio_extension", "wav"),
        shared=make_dataclass_from(SharedConfig, cfg.get("shared", {})),
        drummers=section.get("drummers"),
        dataset_size=section.get("dataset_size", "m"),
        drums_only=section.get("drums_only", True),
        num_audio_files=section.get("num_audio_files"),
        chunk_size_mb=section.get("chunk_size_mb", 512),
    )
    PARSERS[name](pcfg).parse()


if __name__ == "__main__":
    main()
