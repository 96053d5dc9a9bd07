"""On the card only (marked `cuda`; each skips without one, decided in a
fixture): a short run of each cell through the command prints the
contract's last line, correct, on the card it names."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run the port's CUDA kernels")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_prints_a_correct_line(card, cell):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed", "2147483659",
                          "--seconds", "12", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
