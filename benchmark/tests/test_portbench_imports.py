"""The import rule, by whole top-level module names: what the command
loads holds neither JAX, jaxlib, flax nor the JAX package (whose name the
port's begins with), and the reference loads nothing of the port either.
Each check runs in a fresh interpreter."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "adt_str_tpu"}

# a tiny training run and a tiny served batch on the CPU through the command's own modules
COMMAND = """
import json, sys, torch
torch.set_num_threads(2)
import benchmark.run, benchmark.calibrate
from benchmark.drivers import train_synth, serve_backlog
from benchmark.tests import tiny
train_synth.run(tiny.train_context(seconds=0.5))
serve_backlog.run(tiny.serve_context(seconds=2.5))
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys
import benchmark.reference, benchmark.reference.model, benchmark.reference.synth, benchmark.reference.fx
import benchmark.reference.adamw, benchmark.reference.checks, benchmark.reference.mel, benchmark.reference.beam
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""


def _top_level(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT / "build"), "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_command_loads_no_jax_and_not_the_jax_package():
    loaded = _top_level(COMMAND)
    assert "adt_str_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level(REFERENCE)
    assert not loaded & (FORBIDDEN | {"adt_str_tpu_torch"})


def test_the_forbidden_check_compares_whole_top_level_names():
    from benchmark import run

    assert "adt_str_tpu_torch" not in run.FORBIDDEN and "adt_str_tpu" in run.FORBIDDEN
    assert {n.split(".")[0] for n in ("adt_str_tpu_torch.models", "jaxtyping")} & set(run.FORBIDDEN) == set()
