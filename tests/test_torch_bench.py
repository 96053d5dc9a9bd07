"""The port's bench (`python -m adt_str_tpu_torch.bench`) and synthesis eval
step on the CPU against the JAX package: the bench's workload helpers equal
`__graft_entry__`'s, its constants and JSON line equal root `bench.py`'s,
and `make_synth_eval_step`'s loss equals JAX's at fp32 with JAX's render
keys replayed as draws."""

import ast
import dataclasses
import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adt_str_tpu.config import SynthConfig as JSynthConfig
from adt_str_tpu.parallel import train_step as jstep
from adt_str_tpu.synth import render as jrender
from adt_str_tpu_torch import bench as tbench
from adt_str_tpu_torch.config import ModelConfig, SynthConfig
from adt_str_tpu_torch.parallel import train_step as tstep
from adt_str_tpu_torch.parallel.mesh import make_mesh
from adt_str_tpu_torch.synth import render as trender
from adt_str_tpu_torch.synth.bank import n_allowed_bins
from test_torch_synth import jax_render_draws
from test_torch_synth_train_step import SYNTH, _bank, synth_batch
from test_torch_train_step import BASE, build

REPO = Path(__file__).resolve().parent.parent


def _root(name):
    sys.path.insert(0, str(REPO))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(REPO))


@pytest.mark.parametrize("seed, max_notes, n_range", [(0, 128, None), (1, 16, None), (2, 8, (1, 9))])
def test_make_notes_equals_graft_entry(seed, max_notes, n_range):
    graft = _root("__graft_entry__")
    kw = dict(max_notes=max_notes, pitches=tbench.NOTE_PITCHES, onset_hi=2.4, n_range=n_range)
    got = tbench.make_notes(np.random.default_rng(seed), 64, **kw)
    ref = graft.make_notes(np.random.default_rng(seed), 64, **kw)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("batch, tokens, seed", [(64, 256, 0), (5, 40, 3)])
def test_token_batch_equals_graft_entry(batch, tokens, seed):
    graft = _root("__graft_entry__")
    ref = graft._make_batch(graft._flagship_config(), batch, tokens, seed=seed, make_wavs=False)
    got = tbench.make_token_batch(batch, tokens, seed=seed)
    assert got.keys() == ref.keys()
    for k in got:
        assert got[k].dtype == np.asarray(ref[k]).dtype
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]))


def test_bench_workload_constants_equal_bench_py():
    """Model, sizes, windows and baseline are root bench.py's; so is the
    bank's and the notes' draw order (bank first, from one generator)."""
    graft, bench = _root("__graft_entry__"), _root("bench")
    ref = dataclasses.asdict(graft._flagship_config())
    got = dataclasses.asdict(tbench.flagship_config())
    assert got == {k: ref[k] for k in got}
    for name in ("REF_STEPS_PER_SEC", "BATCH_SIZE", "MAX_TOKENS", "MAX_NOTES", "WARMUP_STEPS", "MEASURE_STEPS",
                 "MEASURE_WINDOWS"):
        assert getattr(tbench, name) == getattr(bench, name), name
    src = (REPO / "bench.py").read_text()
    assert "[35, 36, 38, 41, 42, 46, 48, 49]" in src and str(tbench.BANK_PITCHES) in src
    assert "pitches=[35, 36, 38, 41, 42, 46, 48], onset_hi=2.4" in src
    assert tbench.NOTE_PITCHES == [35, 36, 38, 41, 42, 46, 48]
    assert "max_len=30720, n_per_bin=8" in src and int(tbench.MAX_ONESHOT_SEC * 24000) == 30720


def _bench_py_line_keys() -> tuple[list[str], dict]:
    """The keys of the dict root bench.py prints, and its constant values."""
    tree = ast.parse((REPO / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(isinstance(k, ast.Constant) and k.value == "metric" for k in node.keys):
            consts = {k.value: v.value for k, v in zip(node.keys, node.values) if isinstance(v, ast.Constant)}
            return [k.value for k in node.keys], consts
    raise AssertionError("bench.py prints no metric dict")


def test_bench_prints_bench_py_line_tiny():
    """`main` at a tiny config on the CPU prints one JSON line with bench.py's
    keys, metric name and unit (the CLI always runs the flagship), calls
    `before_windows` once and returns each timed window's seconds."""
    cfg = ModelConfig(sample_rate=4000, win_length=256, time_res=0.01, input_sec=0.64, enc_layers=1, dec_layers=1,
                      nhead=2, d_query=16, tgt_vocab_size=1400, n_mels=16, compute_dtype="float32",
                      max_positions=300, dropout=0.1, use_pallas_mel=True)
    out, calls = io.StringIO(), []
    with redirect_stdout(out):
        line, bench, windows = tbench.main(cfg, device="cpu", batch_size=2,
                                           before_windows=lambda: calls.append(1))
    lines = out.getvalue().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == line
    assert calls == [1] and len(windows) == tbench.MEASURE_WINDOWS
    assert bench.state.step == tbench.WARMUP_STEPS + tbench.MEASURE_WINDOWS * tbench.MEASURE_STEPS
    keys, consts = _bench_py_line_keys()
    assert list(line) == keys
    assert line["metric"] == consts["metric"] == "synth_train_steps_per_sec_bs64"
    assert line["unit"] == consts["unit"]
    steps_per_sec = tbench.MEASURE_STEPS / min(windows)  # bench.py rounds both from the unrounded rate
    assert line["value"] == round(steps_per_sec, 3) > 0
    assert line["vs_baseline"] == round(steps_per_sec / tbench.REF_STEPS_PER_SEC, 3)


def test_bench_trims_notes_to_a_48_slot_bucket():
    """The flagship workload's rows hold at most 39 notes: the batch is
    trimmed to 48 slots, as the JAX bench's collate trims it."""
    notes, mask = tbench.make_notes(np.random.default_rng(0), 64, 128, tbench.NOTE_PITCHES, 2.4)
    assert tbench.trim_note_bucket({"notes": notes, "note_mask": mask})["notes"].shape[1] == 48


@pytest.mark.parametrize("seed", [0, 1])
def test_synth_eval_step_loss_equals_jax(seed):
    """The loss of a note batch rendered under JAX's rng (its per-row render
    keys replayed as draws) within 1e-5 relative, at fp32, with dropout
    configured (eval runs none)."""
    params, jcfg, model, tcfg = build(dict(BASE, dropout=0.1), seed=seed)
    jsynth, tsynth = JSynthConfig(**SYNTH), SynthConfig(**SYNTH)
    bank = _bank()
    jstatics = jrender.SynthStatics.from_bank(bank)
    tstatics = trender.SynthStatics.from_bank(bank, device="cpu")
    b = synth_batch(seed=seed)
    rng = jax.random.PRNGKey(40 + seed)
    ref = jstep.make_synth_eval_step(jcfg, jsynth, jstatics)(params, {k: jnp.asarray(v) for k, v in b.items()}, rng)
    draws = jax_render_draws(jstatics, jax.random.split(rng, b["notes"].shape[0]),
                             n_allowed_bins(tsynth.similarity_threshold), False, tsynth.mixup_range,
                             tsynth.use_fx_prob, (tsynth.use_reverb_prob, tsynth.use_compression_prob,
                                                  tsynth.use_limiter_prob))
    tb = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v) for k, v in b.items()}
    got = tstep.make_synth_eval_step(tcfg, tsynth, tstatics, device="cpu")(model, tb, draws)
    assert not got.requires_grad
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)


def test_synth_eval_step_refuses_a_mesh_and_missing_bins():
    _, _, _, tcfg = build(dict(BASE, dropout=0.1))
    statics = trender.SynthStatics.from_bank(_bank(), device="cpu")
    cfg = SynthConfig(**SYNTH)
    # data parallelism is ported: a step runs one process a rank, so a one-process mesh of two entries is refused
    with pytest.raises(ValueError, match="one process a rank"):
        tstep.make_synth_eval_step(tcfg, cfg, statics, mesh=make_mesh(devices=["cpu", "cpu"]))
    with pytest.raises(ValueError, match="loaded with only the leading"):
        tstep.make_synth_eval_step(tcfg, cfg, statics._replace(loaded_bins=2), device="cpu")
