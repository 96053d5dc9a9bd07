"""Training-step throughput of the flagship synthesis-fused step on one GPU:
`python -m adt_str_tpu_torch.bench [--device D]`.

Port of the root `bench.py`: the setting-1 flagship model (d_model 768,
4+4 layers, vocab 1400, 2.56 s chunks at 24 kHz, bf16, K1 log-mel on,
dropout 0.1) trains at batch 64 on 256-token targets, each step rendering
its audio on the device from note lists (3-39 notes a row over 7 pitches,
trimmed to a 48-slot bucket by `trim_note_bucket`) with a synthetic
one-shot bank (8 pitches x 3 bins x 8 rows of 1.28 s), then forward, fp32
loss, backward and AdamW (lr 1e-4, warmup 0.1 of 10,000 steps). Three warm-up steps (the kernel builds
and the allocator's growth among them), then three windows of 20 steps,
each ending on a host read of its last loss. Every step draws new render
draws (on the device) and dropout site keys (host integers, as the
kernels take them) from seeded generators. Prints one JSON line:
{"metric", "value" (steps/s of the best window), "unit", "vs_baseline"}.

`REF_STEPS_PER_SEC` is the root bench's baseline: the measured upper bound
of the PyTorch reference's CPU-synthesis-bound setting-1 throughput.

The workload's helpers are the port's own copies of `__graft_entry__.py`'s
`_flagship_config`, `make_notes` and the token part of `_make_batch`.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from adt_str_tpu_torch import resolve_device
from adt_str_tpu_torch.config import ModelConfig, SynthConfig, TrainingConfig
from adt_str_tpu_torch.data.datasets import trim_note_bucket
from adt_str_tpu_torch.models.adt import ADTModel, draw_site_keys
from adt_str_tpu_torch.parallel.train_step import TrainState, init_train_state, make_synth_train_step
from adt_str_tpu_torch.synth.bank import make_test_bank
from adt_str_tpu_torch.synth.render import SynthStatics, draw_render
from adt_str_tpu_torch.training.optimizer import make_optimizer

REF_STEPS_PER_SEC = 3.256
METRIC = "synth_train_steps_per_sec_bs64"
BATCH_SIZE = 64
MAX_TOKENS = 256
MAX_NOTES = 128
WARMUP_STEPS = 3
MEASURE_STEPS = 20
MEASURE_WINDOWS = 3
BANK_PITCHES = [35, 36, 38, 41, 42, 46, 48, 49]
NOTE_PITCHES = [35, 36, 38, 41, 42, 46, 48]
MAX_ONESHOT_SEC = 1.28  # bank rows of 30720 samples at 24 kHz


def flagship_config() -> ModelConfig:
    return ModelConfig(input_sec=2.56, time_res=0.01, win_length=2048, sample_rate=24000, enc_layers=4,
                       dec_layers=4, nhead=6, d_query=128, dropout=0.1, tgt_vocab_size=1400, n_mels=128,
                       compute_dtype="bfloat16", use_pallas_mel=True)


def make_notes(rng: np.random.Generator, batch_size: int, max_notes: int, pitches, onset_hi: float, n_range=None):
    """(notes (B, max_notes, 4), mask (B, max_notes)): each row n notes
    (n uniform in `n_range`, default [3, 40) clipped to max_notes) at sorted
    uniform onsets below `onset_hi`, 0.05 s long, random pitches and
    velocities 30-126."""
    if n_range is None:
        n_range = (min(3, max_notes), min(40, max_notes + 1))
    notes = np.zeros((batch_size, max_notes, 4), np.float32)
    mask = np.zeros((batch_size, max_notes), bool)
    for i in range(batch_size):
        n = int(rng.integers(*n_range))
        onsets = np.sort(rng.uniform(0, onset_hi, n))
        notes[i, :n] = np.stack([onsets, onsets + 0.05, rng.choice(pitches, n), rng.integers(30, 127, n)], axis=1)
        mask[i, :n] = True
    return notes, mask


def make_token_batch(batch_size: int, max_tokens: int, seed: int = 0) -> dict[str, np.ndarray]:
    """{"tokens": (B, max_tokens) int32 rows [BOS, time, pitch, velocity ...,
    EOS, PAD ...] of random lengths, "token_lengths": (B,) int32 collated}."""
    rng = np.random.default_rng(seed)
    tokens = np.full((batch_size, max_tokens), 1, dtype=np.int32)
    tokens[:, 0] = 2
    for i in range(batch_size):
        n = int(rng.integers(4, max_tokens - 1))
        body = np.stack([rng.integers(4, 300, (n - 2) // 3 + 1), rng.integers(300, 400, (n - 2) // 3 + 1),
                         rng.integers(400, 528, (n - 2) // 3 + 1)], axis=1).reshape(-1)[: n - 2]
        tokens[i, 1 : n - 1] = body
        tokens[i, n - 1] = 3
    lengths = (tokens != 1).sum(axis=1).astype(np.int32)
    lengths = lengths - (lengths == lengths.max()).astype(np.int32)
    return {"tokens": tokens, "token_lengths": lengths}


@dataclass
class Bench:
    """The bench's step, train state and inputs on one device."""

    config: ModelConfig
    synth: SynthConfig
    statics: SynthStatics
    step: object
    state: TrainState
    batch: dict
    draw_gen: torch.Generator
    key_gen: torch.Generator

    def run_step(self) -> dict:
        """One training step on new draws and site keys -> its metrics."""
        draws = draw_render(self.statics, self.batch["tokens"].shape[0], self.synth, self.draw_gen)
        self.state, metrics = self.step(self.state, self.batch, draws, draw_site_keys(self.config, self.key_gen))
        return metrics

    def warm_up(self, steps: int = WARMUP_STEPS) -> float:
        for _ in range(steps):
            metrics = self.run_step()
        return float(metrics["loss"])

    def time_windows(self, steps: int = MEASURE_STEPS, windows: int = MEASURE_WINDOWS) -> list[float]:
        """Host seconds of each window of `steps` steps, each ending on a
        host read of its last loss (which depends on every step before it)."""
        out = []
        for _ in range(windows):
            t0 = time.perf_counter()
            for _ in range(steps):
                metrics = self.run_step()
            loss = float(metrics["loss"])
            out.append(time.perf_counter() - t0)
            if not math.isfinite(loss):
                raise RuntimeError(f"the bench's loss is not finite: {loss}")
        return out


def setup(config: ModelConfig, device=None, batch_size: int = BATCH_SIZE, max_tokens: int = MAX_TOKENS) -> Bench:
    """The bench's workload at `config` on `device` (None: cuda)."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    bank = make_test_bank(rng, BANK_PITCHES, sample_rate=config.sample_rate,
                          max_len=int(MAX_ONESHOT_SEC * config.sample_rate), n_per_bin=8)
    synth = SynthConfig(sample_rate=config.sample_rate, input_sec=config.input_sec, mixup_range=0.8,
                        use_fx_prob=0.3, similarity_threshold=0.8, max_notes=MAX_NOTES,
                        max_oneshot_sec=MAX_ONESHOT_SEC)
    statics = SynthStatics.from_bank(bank, device=device)
    model = ADTModel(config, seed=0, device=device)
    opt, _ = make_optimizer(TrainingConfig(learning_rate=1e-4, warmup_ratio=0.1), total_steps=10_000, model=model)
    notes, mask = make_notes(rng, batch_size, max_notes=MAX_NOTES, pitches=NOTE_PITCHES, onset_hi=2.4)
    trimmed = trim_note_bucket({"notes": notes, "note_mask": mask})
    tokens = make_token_batch(batch_size, max_tokens)
    batch = {"notes": torch.from_numpy(trimmed["notes"]).to(device),
             "note_mask": torch.from_numpy(trimmed["note_mask"]).to(device),
             **{k: torch.from_numpy(v.astype(np.int64)).to(device) for k, v in tokens.items()}}
    return Bench(config=config, synth=synth, statics=statics,
                 step=make_synth_train_step(config, synth, statics, opt, device=device),
                 state=init_train_state(model, opt), batch=batch,
                 draw_gen=torch.Generator(device=device).manual_seed(0), key_gen=torch.Generator().manual_seed(0))


def result_line(window_s: list[float], steps: int) -> dict:
    """The bench's line from its windows' seconds, `steps` steps each."""
    steps_per_sec = steps / min(window_s)
    return {"metric": METRIC, "value": round(steps_per_sec, 3), "unit": "steps/s",
            "vs_baseline": round(steps_per_sec / REF_STEPS_PER_SEC, 3)}


def main(config: ModelConfig | None = None, device=None, batch_size: int = BATCH_SIZE,
         before_windows=None) -> tuple[dict, Bench, list[float]]:
    """Run the bench (the flagship unless `config` says otherwise) and print
    its line -> (the line, the Bench, each window's seconds).
    `before_windows()`, if given, is called between the warm-up and the
    timed windows."""
    bench = setup(config or flagship_config(), device, batch_size)
    bench.warm_up()
    if before_windows is not None:
        before_windows()
    windows = bench.time_windows()
    line = result_line(windows, MEASURE_STEPS)
    print(json.dumps(line), flush=True)
    return line, bench, windows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Flagship synthesis-fused training-step throughput on one GPU")
    parser.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    main(device=parser.parse_args().device)
