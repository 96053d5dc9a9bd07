"""The port's synthesis-fused training step (`make_synth_train_step`)
against the JAX package's, on the CPU, and the setting-1 configuration that
`chip_smoke.py` drives.

Both sides compute in fp32 from the same weights, bank and notes. JAX's step
splits its rng into `k_synth` and `k_model` (`train_step.py:272-273`); the
port gets the same randomness as data: `k_synth`'s per-row keys replayed as
a `RenderDraws` (`test_torch_synth.jax_render_draws`) and `k_model`'s
dropout keys as site keys (`test_torch_train_step.jax_site_keys`). K1 stays
off (see `test_torch_train_step.py`); K2 and K3 run their plain versions.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adt_str_tpu.config import FrameworkConfig as JFrameworkConfig
from adt_str_tpu.config import SynthConfig as JSynthConfig
from adt_str_tpu.config import TrainingConfig as JTrainingConfig
from adt_str_tpu.parallel import train_step as jstep
from adt_str_tpu.synth import render as jrender
from adt_str_tpu.synth.bank import make_test_bank
from adt_str_tpu.training import optimizer as jopt
from adt_str_tpu_torch.config import FrameworkConfig, ModelConfig, SynthConfig, TrainingConfig
from adt_str_tpu_torch.models.convert import state_dict_from_jax_params
from adt_str_tpu_torch.parallel import train_step as tstep
from adt_str_tpu_torch.parallel.mesh import make_mesh
from adt_str_tpu_torch.synth import render as trender
from adt_str_tpu_torch.synth.bank import n_allowed_bins
from adt_str_tpu_torch.synth.fx import FxParams
from adt_str_tpu_torch.training import optimizer as topt
from test_torch_synth import jax_render_draws
from test_torch_train_step import BASE, build, jax_site_keys, make_batch

REPO = Path(__file__).resolve().parent.parent
SR, CHUNK_SEC, L = 4000, 0.64, 512
SYNTH = dict(sample_rate=SR, input_sec=CHUNK_SEC, win_length=256, time_res=0.01, similarity_threshold=0.8,
             mixup_range=0.8, use_fx_prob=0.6, max_notes=16, max_oneshot_sec=L / SR)
PITCHES = [35, 38, 42, 48]


def _bank():
    return make_test_bank(np.random.default_rng(0), PITCHES, sample_rate=SR, max_len=L)


def synth_batch(B=3, max_notes=16, seed=0):
    """Note lists (row 0 full, the others ragged) and `make_batch`'s tokens."""
    rng = np.random.default_rng(seed)
    notes = np.zeros((B, max_notes, 4), np.float32)
    mask = np.zeros((B, max_notes), bool)
    for b in range(B):
        n = max_notes if b == 0 else int(rng.integers(3, max_notes))
        on = rng.uniform(0, CHUNK_SEC, n).astype(np.float32)
        notes[b, :n] = np.stack([on, on + 0.05, rng.choice(PITCHES, n), rng.integers(1, 128, n)], 1)
        mask[b, :n] = True
    tok = make_batch(ModelConfig(**BASE), B=B, seed=seed)
    return {"notes": notes, "note_mask": mask, "tokens": tok["tokens"], "token_lengths": tok["token_lengths"]}


def test_three_synth_train_steps_match_jax():
    """Three steps on one note batch, each with its own rng: loss (the
    renders differ by the rfft path's rounding, rtol 1e-5), grad_norm (2e-4,
    as `test_three_train_steps_match_jax`) and every parameter (5e-5; the
    zero-gradient key third of each `in_proj_bias` to the summed lr)."""
    params, jcfg, model, tcfg = build(dict(BASE, dropout=0.1))
    jsynth, tsynth = JSynthConfig(**SYNTH), SynthConfig(**SYNTH)
    bank = _bank()
    jstatics = jrender.SynthStatics.from_bank(bank)
    tstatics = trender.SynthStatics.from_bank(bank, device="cpu")
    train = dict(learning_rate=1e-3, warmup_ratio=0.2, weight_decay=1e-2, max_grad_norm=1.0)
    tx, _ = jopt.make_optimizer(JTrainingConfig(**train), total_steps=10, params=params)
    opt, sched = topt.make_optimizer(TrainingConfig(**train), total_steps=10, model=model)
    jfn = jstep.make_synth_train_step(jcfg, jsynth, jstatics, tx)
    tfn = tstep.make_synth_train_step(tcfg, tsynth, tstatics, opt, device="cpu")
    js, ts = jstep.init_train_state(params, tx), tstep.init_train_state(model, opt)
    b = synth_batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v) for k, v in b.items()}
    n_allowed = n_allowed_bins(tsynth.similarity_threshold)
    fx_probs = (tsynth.use_reverb_prob, tsynth.use_compression_prob, tsynth.use_limiter_prob)
    fx_rows = 0
    for i in range(3):
        rng = jax.random.PRNGKey(100 + i)
        js, jm = jfn(js, jb, rng)
        k_synth, k_model = jax.random.split(rng)
        draws = jax_render_draws(jstatics, jax.random.split(k_synth, 3), n_allowed, False, tsynth.mixup_range,
                                 tsynth.use_fx_prob, fx_probs)
        fx_rows += int(draws.use_fx.sum())
        ts, tm = tfn(ts, tb, draws, torch.from_numpy(jax_site_keys(k_model, jcfg)))
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5, err_msg=str(i))
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=2e-4, err_msg=str(i))
    assert fx_rows > 0 and ts.step == 3
    lr_sum = sum(sched(i) for i in range(3))
    ref = state_dict_from_jax_params(jax.tree.map(np.asarray, js.params))
    for n, p in model.named_parameters():
        got, want = p.detach().numpy(), ref[n].numpy()
        if n.endswith("in_proj_bias"):  # q | k | v thirds: only k is held to lr_sum
            d = got.shape[0] // 3
            np.testing.assert_allclose(got[d : 2 * d], want[d : 2 * d], atol=lr_sum, rtol=0, err_msg=n + " k")
            got, want = np.delete(got, np.s_[d : 2 * d]), np.delete(want, np.s_[d : 2 * d])
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=0, err_msg=n)


def test_fx_compaction_with_every_row_drawing_fx():
    """B = 64 at p = 0.3: the budget is 42 rows. With all 64 `use_fx` true,
    rows 0-41 (the first in stable order) run the chain and rows 42-63 skip
    it, exactly as if only rows 0-41 had drawn it."""
    cfg = SynthConfig(**dict(SYNTH, use_fx_prob=0.3))
    statics = trender.SynthStatics.from_bank(_bank(), device="cpu")
    B = 64
    notes = torch.from_numpy(np.tile(synth_batch(1)["notes"], (B, 1, 1)))
    mask = torch.from_numpy(np.tile(synth_batch(1)["note_mask"], (B, 1)))
    draws = trender.draw_render(statics, B, cfg, torch.Generator().manual_seed(0))
    draws = draws._replace(fx=FxParams(*(torch.ones_like(f) if f.dtype == torch.bool else f for f in draws.fx)))
    assert trender.fx_budget(B, cfg.use_fx_prob) == 42

    def render(use_fx):
        return trender.render_batch(statics, notes, mask, draws._replace(use_fx=use_fx), cfg)

    every = render(torch.ones(B, dtype=torch.bool))
    first = render(torch.arange(B) < 42)
    none = render(torch.zeros(B, dtype=torch.bool))
    assert torch.equal(every, first)
    assert torch.equal(every[42:], none[42:])
    assert (every[:42] - none[:42]).abs().amax(1).min() > 1e-3  # the chain ran on each of them


def test_synth_train_step_refuses_a_mesh_a_bank_elsewhere_and_missing_bins(monkeypatch):
    _, _, model, tcfg = build(dict(BASE, dropout=0.1))
    opt, _ = topt.make_optimizer(TrainingConfig(), total_steps=10, model=model)
    statics = trender.SynthStatics.from_bank(_bank(), device="cpu")
    cfg = SynthConfig(**SYNTH)
    # data parallelism is ported (test_torch_ddp.py): a one-process mesh of two entries is refused
    with pytest.raises(ValueError, match="one process a rank"):
        tstep.make_synth_train_step(tcfg, cfg, statics, opt, mesh=make_mesh(devices=["cpu", "cpu"]))
    with pytest.raises(ValueError, match="loaded with only the leading"):
        tstep.make_synth_train_step(tcfg, cfg, statics._replace(loaded_bins=2), opt, device="cpu")
    with pytest.raises(ValueError, match="bank lies on"):
        tstep.make_synth_train_step(tcfg, cfg, statics, opt, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        tstep.make_synth_train_step(tcfg, cfg, statics, opt)


def test_chip_smoke_synth_config_matches_setting_1_yaml(monkeypatch):
    """chip_smoke.py reads configs/train/setting-1.yaml with the port's own
    reader (the machine with the card has no PyYAML): with PyYAML blocked it
    gives the JAX package's typed config."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    assert chip_smoke.SYNTH_YAML == "configs/train/setting-1.yaml"
    jax_cfg = JFrameworkConfig.from_yaml(REPO / chip_smoke.SYNTH_YAML)
    monkeypatch.setitem(sys.modules, "yaml", None)
    yaml_cfg = chip_smoke.load_config(chip_smoke.SYNTH_YAML, train=True)
    for section in ("shared", "tokenizer", "model"):
        assert dataclasses.asdict(getattr(yaml_cfg, section)) == dataclasses.asdict(getattr(jax_cfg, section)), section
    for section in ("training", "synthetiser"):  # the port's fields are a subset of the JAX package's
        port, ref = dataclasses.asdict(getattr(yaml_cfg, section)), dataclasses.asdict(getattr(jax_cfg, section))
        assert port == {k: ref[k] for k in port}, section
    m, s = yaml_cfg.model, yaml_cfg.synthetiser
    assert m.use_pallas_mel and not m.use_pallas_ffn and not m.use_flash_attention and m.dropout == 0.1
    assert m.d_model == 768 and (m.enc_layers, m.dec_layers) == (4, 4)
    assert s.max_notes == 128 and s.chunk_samples == 61440 and int(s.max_oneshot_sec * s.sample_rate) == 30720
    assert n_allowed_bins(s.similarity_threshold) == 3 and trender.fx_budget(64, s.use_fx_prob) == 42
