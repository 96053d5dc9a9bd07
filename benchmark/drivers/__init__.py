"""The drivers of the timed path, one a kind of traffic (the mix's `kind`):
each builds the system under test from the cell's configuration, warms up
the cell's own shapes, runs the measured window, reads a traced sub-window
when asked, and then holds what the window produced to the reference.

A driver's `run(ctx)` returns a dict: "e2e" (end-to-end metric values),
"layer" (what the per-layer readers read), "correct", "checks" ({name:
[value, limit]}), "attempted", "failed", "memory_peak_bytes" and "trace"
(the traced span's summary, or None)."""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch


@dataclass
class Context:
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    config: dict  # benchmark/configs/<config>.json
    mix: dict  # benchmark/traffic/<traffic>.json
    t_start: float  # time.monotonic() at process start
    work_dir: Path  # inside the checkout, listed in .gitignore

    def mark(self, what: str) -> None:
        """A set-up milestone on standard error, in seconds since the process began."""
        print(f"setup: {what} at {now() - self.t_start:.3f} s", file=sys.stderr, flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def now() -> float:
    return time.monotonic()


def dims_of(model_cfg) -> dict:
    """The reference's sizes from the port's ModelConfig."""
    return {"d_model": model_cfg.d_model, "nhead": model_cfg.nhead, "enc_layers": model_cfg.enc_layers,
            "dec_layers": model_cfg.dec_layers, "vocab": model_cfg.tgt_vocab_size, "n_mels": model_cfg.n_mels,
            "sample_rate": model_cfg.sample_rate, "win_length": model_cfg.win_length,
            "hop": model_cfg.hop_length, "max_positions": model_cfg.max_positions}


def check(name: str, value: float, limit: float) -> tuple[str, list]:
    return name, [float(value), float(limit)]
