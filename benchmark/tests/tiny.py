"""Tiny cells for runs on the CPU: the cells' configurations and mixes cut
to a size a test run holds (one layer each side, two heads of 32, short
one-shots, few notes and tokens, small buckets), driven through the same
drivers with the kernels' plain versions."""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path

import torch

from benchmark.drivers import Context

ROOT = Path(__file__).resolve().parents[2]


def _load(rel: str) -> dict:
    return json.loads((ROOT / rel).read_text())


def train_context(seed: int = 7, seconds: float = 2.0, **mix_over) -> Context:
    config = copy.deepcopy(_load("benchmark/configs/setting-1.json"))
    s = config["sections"]
    s["model"].update(enc_layers=1, dec_layers=1, nhead=2, d_query=32)
    s["training"]["batch_size"] = 4
    s["TrainDatasetConfig"]["max_tokens"] = 64
    s["synthetiser"].update(max_notes=16, max_oneshot_sec=0.08)
    config["assumed"]["bank_rows_per_bin"] = 2
    mix = _load("benchmark/traffic/synth_notes_b64.json")
    # the tiny cell's own limits, from its readings on the CPU: sound first gradients 0.004-0.006, the fp8
    # control's 0.018-0.026; its small leaves' Adam steps read 0.19-0.21 in sound runs and the control alike
    mix.update(notes_min=3, notes_max=16, trace_steps=2, limits={"grad_gap": 0.012, "change_gap": 0.5}, **mix_over)
    return Context(seed=seed, seconds=seconds, trace=False, device=torch.device("cpu"), config=config, mix=mix,
                   t_start=time.monotonic(), work_dir=ROOT / "build" / "benchmark-tests")


def serve_context(seed: int = 7, seconds: float = 3.0, **mix_over) -> Context:
    config = copy.deepcopy(_load("benchmark/configs/ENSTserving.json"))
    s = config["sections"]
    s["model"].update(enc_layers=1, dec_layers=1, nhead=2, d_query=32)
    s["inference"]["max_length"] = 64
    s["serving"]["buckets"] = [1, 2, 4]
    mix = _load("benchmark/traffic/backlog_greedy.json")
    # the tiny cell's own limit, from its readings on the CPU over 12 seeds: sound 0-0.026, the fp8 control's
    # own greedy rows 0.103-0.465
    mix.update(songs=8, pool=8, song_seconds=[5, 20], clients=6, min_queued=2, check_chunks=4, check_block=2,
               limits={"served_gap": 0.06}, **mix_over)
    return Context(seed=seed, seconds=seconds, trace=False, device=torch.device("cpu"), config=config, mix=mix,
                   t_start=time.monotonic(), work_dir=ROOT / "build" / "benchmark-tests")
