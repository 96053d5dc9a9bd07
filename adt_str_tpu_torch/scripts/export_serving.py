"""Serving export: the compile-once artifact of greedy transcription.

Port of `tools/export_serving.py`. It exports the KV-cache greedy decode
(`models/decode.py:greedy_decode`, as the traceable `GreedyProgram`) with
`torch.export`: the weights are baked into the program, so a serving host
needs only the saved bytes, `torch.export.load` and `import
adt_str_tpu_torch.ops` (which registers the custom ops of the kernels the
program calls: K1, K5f, LayerNorm, the product and attention_rows). No model
code, checkpoint loader or config system is needed. The loop is one
`torch.while_loop` with the data-dependent exit of the eager loop (every row
finished, or `max_length - 1` steps). A program exported on the card runs
on the card, one exported on the CPU runs on the CPU.

Usage:
  python -m adt_str_tpu_torch.scripts.export_serving <config.yaml> --out DIR
      [--batch 64]        fixed batch size (default)
      [--poly-batch]      symbolic batch dimension instead (1-64 rows at run time)
      [--max-length N]    override inference.max_length
      [--check]           load the saved artifact, run it and compare with a
                          direct greedy_decode call on random audio
      [--device cpu]      export on the CPU (default: cuda, which must exist)

Writes `DIR/transcribe_greedy.pt2` (`torch.export.save`) and `DIR/meta.json`
(shapes, token ids, sample rate, platform, torch version).

Consumer sketch:
    import torch
    import adt_str_tpu_torch.ops  # registers the kernels' ops
    program = torch.export.load("transcribe_greedy.pt2").module()
    with torch.no_grad():
        tokens = program(wavs)  # (B, chunk_samples) f32 -> (B, max_length) i32
"""

from __future__ import annotations

import argparse
import io
import json
import os

import torch

from adt_str_tpu_torch import resolve_device
from adt_str_tpu_torch.config import FrameworkConfig
from adt_str_tpu_torch.domain.tokenizer import MidiTokenizer
from adt_str_tpu_torch.models.adt import ADTModel
from adt_str_tpu_torch.models.convert import load_reference_checkpoint
from adt_str_tpu_torch.models.decode import GreedyProgram, greedy_decode

ARTIFACT = "transcribe_greedy.pt2"
MAX_BATCH = 64  # the serving config's largest bucket: the symbolic batch's upper bound
SAMPLE_BATCH = 2  # the rows a symbolic batch is traced with (export takes a batch of 1 as a constant)


def build_exported(
    model: ADTModel,
    max_length: int,
    start_token: int = 2,
    end_token: int = 3,
    batch_size: int | None = 64,
) -> torch.export.ExportedProgram:
    """Export greedy transcription on `model`'s device as a
    `torch.export.ExportedProgram`.

    `batch_size=None` exports with a symbolic batch dimension (the program
    then takes 1 to `MAX_BATCH` rows). The weights are held in the program,
    the decoder's already cast to the compute dtype, so it stands alone."""
    program = GreedyProgram(model, max_length, start_token, end_token)
    device = next(program.buffers()).device
    rows = SAMPLE_BATCH if batch_size is None else int(batch_size)
    wave = torch.zeros(rows, model.config.chunk_samples, device=device)
    dynamic = ({0: torch.export.Dim("b", min=1, max=MAX_BATCH)},) if batch_size is None else None
    with torch.no_grad():
        return torch.export.export(program, (wave,), dynamic_shapes=dynamic)


def to_bytes(exported: torch.export.ExportedProgram) -> bytes:
    """The bytes `torch.export.save` writes."""
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def from_bytes(blob: bytes) -> torch.nn.Module:
    """The runnable module of saved bytes (the kernels' ops must be
    registered: `import adt_str_tpu_torch.ops`)."""
    return torch.export.load(io.BytesIO(blob)).module()


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument("config_path", type=str)
    parser.add_argument("--out", type=str, default="exports/")
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--poly-batch", action="store_true",
                        help="symbolic batch dimension instead of a fixed --batch")
    parser.add_argument("--max-length", type=int, default=None)
    parser.add_argument("--check", action="store_true")
    parser.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    cfg = FrameworkConfig.from_yaml(args.config_path)
    if cfg.inference is None or not cfg.inference.checkpoint_path:
        raise SystemExit("config needs `inference.checkpoint_path`")
    device = resolve_device(args.device)
    model = ADTModel(cfg.model, device=device)
    model.load_state_dict(load_reference_checkpoint(cfg.inference.checkpoint_path, device), strict=True)
    model.eval()
    tokenizer = MidiTokenizer(cfg.tokenizer)
    max_length = int(args.max_length or cfg.inference.max_length)
    batch = None if args.poly_batch else args.batch

    blob = to_bytes(build_exported(model, max_length, start_token=tokenizer.BOS_token,
                                   end_token=tokenizer.EOS_token, batch_size=batch))
    os.makedirs(args.out, exist_ok=True)
    art_path = os.path.join(args.out, ARTIFACT)
    with open(art_path, "wb") as f:
        f.write(blob)
    shape = "b" if batch is None else batch
    meta = {
        "artifact": ARTIFACT,
        "input": {
            "shape": [shape, cfg.model.chunk_samples],
            "dtype": "float32",
            "sample_rate": cfg.shared.sample_rate,
            "seconds_per_chunk": cfg.shared.input_sec,
        },
        "output": {
            "shape": [shape, max_length],
            "dtype": "int32",
            "bos_token": tokenizer.BOS_token,
            "eos_token": tokenizer.EOS_token,
            "pad_token": tokenizer.pad_token,
            "vocab_size": cfg.model.tgt_vocab_size,
        },
        "platforms": [device.type],
        "torch_version": torch.__version__,
        "checkpoint": cfg.inference.checkpoint_path,
        "requires": "import adt_str_tpu_torch.ops (registers the kernels' custom ops) before torch.export.load",
    }
    with open(os.path.join(args.out, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    print(f"exported {art_path} ({len(blob) / 1e6:.1f} MB, platforms={meta['platforms']}, "
          f"batch={'poly' if batch is None else batch}, max_length={max_length})")

    if args.check:
        program = from_bytes(blob)
        b_check = SAMPLE_BATCH if batch is None else batch
        gen = torch.Generator().manual_seed(0)
        wavs = torch.randn(b_check, cfg.model.chunk_samples, generator=gen).to(device)
        with torch.no_grad():
            got = program(wavs)
        want = greedy_decode(model, wavs, max_length, tokenizer.BOS_token, tokenizer.EOS_token)
        if not torch.equal(got, want):
            raise SystemExit(f"check failed: the artifact's tokens differ from a direct greedy_decode at B={b_check}")
        print(f"check OK: artifact output matches direct decode at B={b_check}")


if __name__ == "__main__":
    main()
