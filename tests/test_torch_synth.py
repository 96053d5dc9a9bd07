"""The port's synthesis layer (`adt_str_tpu_torch/synth/`, its mapping
tables and `SynthConfig`) against the JAX package's, on the CPU.

Tables, banks and configs must be equal. The draws are tested by their
distribution: torch cannot reproduce `jax.random` streams. The whole render
is held to JAX's `render_batch_arrays(pallas="xla")` given JAX's own draws:
`jax_render_draws` replays JAX's key splits (`render.py:306-319`, and
`fx.py:515-539` through `test_torch_fx.jax_fx_params`) into a `RenderDraws`.
Tolerance there: atol 2e-4, rtol 1e-3, the JAX package's own integration
tolerance between its Pallas and XLA renders (`tests/test_synth.py`):
JAX's XLA path convolves in the frequency domain, the port places notes
directly, and the port blends in f32 where XLA blends in the bank's dtype.
"""

import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adt_str_tpu.config import FrameworkConfig as JFrameworkConfig
from adt_str_tpu.config import SynthConfig as JSynthConfig
from adt_str_tpu.synth import bank as jbank
from adt_str_tpu.synth import render as jrender
from adt_str_tpu.utils import mappings as jmap
from adt_str_tpu_torch.config import FrameworkConfig, SynthConfig
from adt_str_tpu_torch.synth import bank as tbank
from adt_str_tpu_torch.synth import render as trender
from adt_str_tpu_torch.synth.render import RenderDraws, SynthStatics
from adt_str_tpu_torch.utils import mappings as tmap
from test_torch_fx import jax_fx_params

REPO = Path(__file__).resolve().parent.parent
SR = 8000
PITCHES = [35, 38, 42, 48]


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _jax_draws(jstatics, keys, n_allowed, adtof, mixup_range, use_fx_prob):
    sub = jax.vmap(lambda k: jax.random.split(k, 5))(keys)
    k_main, k_sub, k_mix, k_usefx, k_fx = (sub[:, i] for i in range(5))
    rows = jax.vmap(lambda k: jrender._sample_timbre_rows(jstatics, k, n_allowed, adtof))
    (main, main_ok), (subr, sub_ok) = rows(k_main), rows(k_sub)
    lam = jax.vmap(lambda k: jax.random.uniform(k, (trender.N_SLOTS, 1), maxval=mixup_range))(k_mix)[..., 0]
    use_fx = jax.vmap(jax.random.uniform)(k_usefx) < use_fx_prob
    return main, subr, main_ok & sub_ok, lam, use_fx, k_fx


def jax_render_draws(jstatics, keys, n_allowed, adtof, mixup_range, use_fx_prob, fx_probs) -> RenderDraws:
    """The draws JAX's `render_batch_arrays` makes from `keys` (one per row),
    as the port's `RenderDraws`."""
    main, subr, slot_ok, lam, use_fx, k_fx = _jax_draws(jstatics, keys, n_allowed, adtof, mixup_range, use_fx_prob)

    def t(a, dtype=None):
        a = torch.from_numpy(np.array(a))
        return a if dtype is None else a.to(dtype)

    return RenderDraws(t(main, torch.int64), t(subr, torch.int64), t(slot_ok), t(lam), t(use_fx),
                       jax_fx_params(k_fx, *fx_probs))


def _entries(rng, spec, L=64):
    """{pitch: {bin: n rows}} -> build_bank entries of random rows of ragged length."""
    return {p: {b: [rng.normal(size=int(rng.integers(L // 2, L + 8))).astype(np.float32) for _ in range(n)]
                for b, n in bins.items()} for p, bins in spec.items()}


def _assert_banks_equal(got, ref):
    np.testing.assert_array_equal(got.waveforms, ref.waveforms)
    for f in ("lengths", "bin_offset", "bin_count"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    assert (got.max_len, got.loaded_bins, got.pitches()) == (ref.max_len, ref.loaded_bins, ref.pitches())


# ------------------------------------------------------------ tables, banks


def test_mapping_tables_match_jax():
    assert tmap.ADTOF_MAPPING == jmap.ADTOF_MAPPING
    assert tmap.ADTOF_INVERSE_MAPPING == jmap.ADTOF_INVERSE_MAPPING
    assert tmap.ADTOF_LABEL_MAPPING == jmap.ADTOF_LABEL_MAPPING
    np.testing.assert_array_equal(tmap.ADTOF_LUT, jmap.ADTOF_LUT)
    assert tmap.ADTOF_LUT.dtype == jmap.ADTOF_LUT.dtype
    np.testing.assert_array_equal(tmap._make_lut({3: 5, 127: 0}), jmap._make_lut({3: 5, 127: 0}))


def test_class_gains_and_member_tables_match_jax():
    np.testing.assert_array_equal(trender.class_gain_lut(), jrender.class_gain_lut())
    for got, ref in zip(trender.adtof_member_tables(), jrender.adtof_member_tables()):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("cap", [None, 3, 1])
def test_build_bank_matches_jax(cap):
    spec = {35: {"gold": 2, "100-90": 1, "70-60": 2}, 38: {"90-80": 3}, 61: {"10-0": 1, "gold": 1}}
    entries = _entries(np.random.default_rng(0), spec)
    _assert_banks_equal(tbank.build_bank(entries, 48, n_allowed_bins=cap), jbank.build_bank(entries, 48, cap))
    assert [tbank.n_allowed_bins(t) for t in (1.0, 0.9, 0.85, 0.8, 0.0)] == \
        [jbank.n_allowed_bins(t) for t in (1.0, 0.9, 0.85, 0.8, 0.0)] == [1, 2, 3, 3, 11]
    with pytest.raises(ValueError, match="empty"):
        tbank.build_bank({}, 8)


def test_bank_hdf5_round_trip_matches_jax(tmp_path):
    entries = _entries(np.random.default_rng(1), {38: {"gold": 1, "90-80": 2, "30-20": 1}, 42: {"gold": 1}})
    path = str(tmp_path / "bank@8000.hdf5")
    tbank.save_bank_hdf5(path, entries, SR)
    for cap in (None, 3):
        _assert_banks_equal(tbank.load_bank_hdf5(path, 128, cap), jbank.load_bank_hdf5(path, 128, cap))
    assert tbank.load_bank_hdf5(path, 128, 3).n_samples == 4


def test_make_test_bank_matches_jax():
    got = tbank.make_test_bank(np.random.default_rng(2), PITCHES, sample_rate=SR, max_len=256)
    ref = jbank.make_test_bank(np.random.default_rng(2), PITCHES, sample_rate=SR, max_len=256)
    _assert_banks_equal(got, ref)


@pytest.fixture(scope="module")
def bank():
    return tbank.make_test_bank(np.random.default_rng(3), PITCHES, sample_rate=SR, max_len=512)


def test_from_bank_tables_and_guard_match_jax(bank, monkeypatch):
    ts = SynthStatics.from_bank(bank, device="cpu")
    js = jrender.SynthStatics.from_bank(bank)
    assert ts.waveforms.dtype == torch.float32 and ts.loaded_bins == js.loaded_bins
    for f in ("waveforms", "bin_offset", "bin_count", "class_gain", "member_table", "member_count"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), err_msg=f)
    assert SynthStatics.from_bank(bank, dtype=torch.bfloat16, device="cpu").waveforms.dtype == torch.bfloat16
    # the capacity guard: the same message in both packages
    with pytest.raises(ValueError) as got:
        SynthStatics.from_bank(bank, hbm_limit_gib=1e-6, device="cpu")
    with pytest.raises(ValueError) as ref:
        jrender.SynthStatics.from_bank(bank, hbm_limit_gib=1e-6)
    assert str(got.value) == str(ref.value) and "device budget" in str(got.value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        SynthStatics.from_bank(bank)


def test_vel_to_vol_and_pad_notes_match_jax():
    v = np.arange(0, 128, dtype=np.float32)
    np.testing.assert_allclose(trender.vel_to_vol(torch.from_numpy(v)).numpy(),
                               np.asarray(jrender.vel_to_vol(jnp.asarray(v))), rtol=1e-6, atol=0)
    assert float(trender.vel_to_vol(torch.tensor(0.0))) == 0.0
    notes = np.array([[0.1, 0.2, 35, 100], [0.5, 0.6, 61, 3]], np.float32)
    for got, ref in zip(trender.pad_notes(notes, 5), jrender.pad_notes(notes, 5)):
        np.testing.assert_array_equal(got, ref)
    for bad in ([[0.1, 0.2, 99, 100]], [[0.3, 0.1, 38, 100]]):
        with pytest.raises(ValueError):
            trender.pad_notes(np.array(bad, np.float32), 8)


def test_check_bins_loaded_matches_jax(tmp_path):
    entries = {35: {b: [np.ones(32, np.float32)] for b in ("gold", "100-90", "90-80", "70-60")}}
    capped = tbank.build_bank(entries, 32, n_allowed_bins=2)
    trender.check_bins_loaded(SynthStatics.from_bank(capped, device="cpu"), 0.9)
    with pytest.raises(ValueError) as got:
        trender.check_bins_loaded(SynthStatics.from_bank(capped, device="cpu"), 0.7)
    with pytest.raises(ValueError) as ref:
        jrender.check_bins_loaded(jrender.SynthStatics.from_bank(jbank.build_bank(entries, 32, 2)), 0.7)
    assert str(got.value) == str(ref.value)


def test_synth_config_matches_jax():
    path = REPO / "configs/train/setting-1.yaml"
    got, ref = FrameworkConfig.from_yaml(path).synthetiser, JFrameworkConfig.from_yaml(path).synthetiser
    # the port keeps the fields its render reads: each equal to the JAX package's
    port, jax_d = dataclasses.asdict(got), dataclasses.asdict(ref)
    assert port == {k: jax_d[k] for k in port}
    assert got.chunk_samples == ref.chunk_samples == 61440 and got.max_oneshot_sec == 1.28
    defaults, jax_defaults = dataclasses.asdict(SynthConfig()), dataclasses.asdict(JSynthConfig())
    assert defaults == {k: jax_defaults[k] for k in defaults}
    assert FrameworkConfig.from_dict({}).synthetiser is None
    tok = FrameworkConfig.from_dict({"tokenizer": {"ADTOF_mapping": True}, "synthetiser": {"mixup_range": 0.5},
                                     "shared": {"sample_rate": 8000}}).synthetiser
    assert tok.ADTOF_mapping and tok.mixup_range == 0.5 and tok.sample_rate == 8000


# ------------------------------------------------------------------ draws

DRAW_SPEC = {35: {"gold": 2, "100-90": 3}, 38: {"gold": 4}, 42: {"90-80": 1, "80-70": 5}, 48: {"80-70": 2},
             43: {"gold": 1}}


@pytest.fixture(scope="module")
def draw_statics():
    return SynthStatics.from_bank(tbank.build_bank(_entries(np.random.default_rng(4), DRAW_SPEC), 16), device="cpu")


def _freq(x: torch.Tensor, value) -> float:
    return (x == value).double().mean().item()


# Frequencies over B = 8000 draws: a share p has a standard deviation of at
# most 0.0056, so 0.025 is over 4 sigma.
TOL = 0.025


def test_draw_render_timbre_split(draw_statics):
    """Uniform over the eligible bins that exist for the pitch, then over
    the bin's timbres; slot_ok false exactly where no bin is eligible."""
    st, B = draw_statics, 8000
    cfg = SynthConfig(similarity_threshold=0.8)  # gold, 100-90, 90-80
    d = trender.draw_render(st, B, cfg, torch.Generator().manual_seed(0))
    assert d.main_rows.shape == d.sub_rows.shape == d.slot_ok.shape == d.lam.shape == (B, 27)
    off = st.bin_offset.numpy()
    s35, s38, s42 = 0, 3, 7
    for rows in (d.main_rows, d.sub_rows):
        for r in range(2):  # gold: half the draws, split over 2 rows
            assert abs(_freq(rows[:, s35], off[35, 0] + r) - 0.25) < TOL
        for r in range(3):  # 100-90: the other half over 3 rows
            assert abs(_freq(rows[:, s35], off[35, 1] + r) - 1 / 6) < TOL
        for r in range(4):
            assert abs(_freq(rows[:, s38], off[38, 0] + r) - 0.25) < TOL
        assert (rows[:, s42] == off[42, 2]).all()  # 80-70 is not eligible at 0.8
    ok = {35, 38, 42, 43}
    assert all(bool(d.slot_ok[:, p - 35].all()) == (p in ok) and bool(d.slot_ok[:, p - 35].any()) == (p in ok)
               for p in range(35, 62))


def test_draw_render_adtof_member_draw(draw_statics):
    """ADTOF mode draws a member pitch first: HH (42) has members 42, 43, 44,
    50, of which 42 and 43 have eligible bins."""
    st, B = draw_statics, 8000
    d = trender.draw_render(st, B, SynthConfig(ADTOF_mapping=True), torch.Generator().manual_seed(1))
    off = st.bin_offset.numpy()
    s42 = 7
    for rows in (d.main_rows, d.sub_rows):
        assert abs(_freq(rows[:, s42], off[42, 2]) - 0.25) < TOL
        assert abs(_freq(rows[:, s42], off[43, 0]) - 0.25) < TOL
    assert abs(d.slot_ok[:, s42].double().mean().item() - 0.25) < TOL  # main and sub both valid
    assert bool(d.slot_ok[:, 43 - 35].all())  # 43 is no ADTOF class: it draws itself
    # BD (35) has members 35, 36; only 35 is in the bank
    assert abs(d.slot_ok[:, 0].double().mean().item() - 0.25) < TOL


def test_draw_render_mixup_fx_choice_and_parameter_ranges(draw_statics):
    B = 8000
    cfg = SynthConfig(mixup_range=0.6, use_fx_prob=0.3, use_reverb_prob=0.5, use_compression_prob=0.2,
                      use_limiter_prob=0.7)
    d = trender.draw_render(draw_statics, B, cfg, torch.Generator().manual_seed(2))
    assert d.lam.min().item() >= 0.0 and d.lam.max().item() < 0.6 and abs(d.lam.mean().item() - 0.3) < 0.01
    assert abs(d.use_fx.double().mean().item() - 0.3) < TOL
    fx = d.fx
    for flag, p in ((fx.use_reverb, 0.5), (fx.use_compression, 0.2), (fx.use_limiter, 0.7)):
        assert flag.dtype == torch.bool and abs(flag.double().mean().item() - p) < TOL
    for v, lo, hi in ((fx.room, 0.2, 0.8), (fx.damping, 0.2, 0.8), (fx.wet, 0.1, 0.4), (fx.width, 0.6, 1.0),
                      (fx.comp_threshold_db, -10.0, 0.0), (fx.comp_ratio, 1.0, 10.0),
                      (fx.comp_attack_ms, 0.0, 1000.0), (fx.comp_release_ms, 0.0, 1000.0),
                      (fx.lim_threshold_db, -3.0, 0.0)):
        assert v.shape == (B,) and v.min().item() >= lo and v.max().item() <= hi
    # the clamped normals: |N(0.5, 0.15)| * 10 has mean ~5 for the ratio
    assert abs(fx.comp_ratio.mean().item() - 5.0) < 0.1


# ------------------------------------------------------------------ render


def _notes(rng, B, max_notes, chunk, pitches):
    notes = np.zeros((B, max_notes, 4), np.float32)
    mask = np.zeros((B, max_notes), bool)
    for b in range(1, B):  # row 0 stays empty
        n = int(rng.integers(2, max_notes + 1)) if b > 1 else max_notes
        on = rng.uniform(0, chunk / SR, n).astype(np.float32)
        notes[b, :n] = np.stack([on, on + 0.05, rng.choice(pitches, n), rng.integers(1, 128, n)], 1)
        mask[b, :n] = True
    notes[2, 0, 0] = 0.0  # onset at the first sample
    return notes, mask


# (B, max_notes, use_fx_prob, adtof): a batch of 4 runs every row through
# the chain; 12 rows at p = 0.1 take the compacted budget of 8 rows. The
# keys (PRNGKey(12)) draw FX for rows 1-3 and for rows 9 and 11.
RENDER_CASES = {"plain": (4, 24, 0.6, False), "adtof-compacted": (12, 16, 0.1, True)}


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_render_given_jax_draws_matches_jax(case, bank):
    B, max_notes, p_fx, adtof = RENDER_CASES[case]
    chunk, mixup, fx_probs = 1280, 0.5, (1.0, 0.5, 0.5)
    rng = np.random.default_rng(5)
    # pitch 50 has no bank rows: its notes are silenced
    notes, mask = _notes(rng, B, max_notes, chunk, PITCHES + [50, 43])
    keys = jax.random.split(jax.random.PRNGKey(12), B)
    js = jrender.SynthStatics.from_bank(bank)
    ref = np.asarray(jrender.render_batch_arrays(
        js, jnp.asarray(notes), jnp.asarray(mask), keys, chunk_samples=chunk, sample_rate=SR, mixup_range=mixup,
        use_fx_prob=p_fx, use_reverb_prob=fx_probs[0], use_compression_prob=fx_probs[1],
        use_limiter_prob=fx_probs[2], n_allowed=3, adtof=adtof, pallas="xla"))
    draws = jax_render_draws(js, keys, 3, adtof, mixup, p_fx, fx_probs)
    assert bool(draws.use_fx.any())
    got = trender.render_batch_arrays(SynthStatics.from_bank(bank, device="cpu"), torch.from_numpy(notes),
                                      torch.from_numpy(mask), draws, chunk, SR, use_fx_prob=p_fx)
    assert got.shape == (B, chunk) and got.dtype == torch.float32
    assert np.abs(ref).max() > 0.1 and (ref[0] == 0).all() and (got[0] == 0).all()
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=1e-3)


def test_render_batch_reads_its_config(bank):
    """`render_batch` takes chunk, rate and the FX probability from the
    config, checks the bank's bins, and is deterministic given the draws."""
    st = SynthStatics.from_bank(bank, device="cpu")
    cfg = SynthConfig(sample_rate=SR, input_sec=0.16, use_fx_prob=0.3)
    notes, mask = _notes(np.random.default_rng(6), 3, 8, cfg.chunk_samples, PITCHES)
    draws = trender.draw_render(st, 3, cfg, torch.Generator().manual_seed(3))
    a = trender.render_batch(st, torch.from_numpy(notes), torch.from_numpy(mask), draws, cfg)
    b = trender.render_batch_arrays(st, torch.from_numpy(notes), torch.from_numpy(mask), draws, cfg.chunk_samples,
                                    SR, use_fx_prob=0.3)
    assert a.shape == (3, 1280) and torch.equal(a, b) and (a[0] == 0).all() and a[1:].abs().amax(1).min() > 0.1
    with pytest.raises(ValueError, match="loaded with only the leading"):
        trender.render_batch(st._replace(loaded_bins=2), torch.from_numpy(notes), torch.from_numpy(mask), draws, cfg)


def test_fx_budget_matches_the_jax_formula():
    assert trender.fx_budget(64, 0.3) == 42
    assert trender.fx_budget(12, 0.1) == 8
    assert trender.fx_budget(16, 0.3) == 16 and trender.fx_budget(8, 0.0) == 0 and trender.fx_budget(8, 1.5) == 8


def test_render_checks_draw_shapes_and_clamps_bank_rows(bank):
    """Draws of another batch shape raise; a row id past the bank (draws
    from a larger bank, or made by hand) reads the bank's last row, as JAX's
    gathers clamp, instead of raising or reading past the bank."""
    st = SynthStatics.from_bank(bank, device="cpu")
    cfg = SynthConfig(sample_rate=SR, input_sec=0.16, use_fx_prob=0.0)
    notes, mask = (torch.from_numpy(a) for a in _notes(np.random.default_rng(7), 3, 8, cfg.chunk_samples, PITCHES))
    draws = trender.draw_render(st, 3, cfg, torch.Generator().manual_seed(4))
    n_rows = st.waveforms.shape[0]
    past = draws._replace(main_rows=draws.main_rows.clone(), sub_rows=draws.sub_rows - 10**6)
    past.main_rows[1:, ::2] = n_rows + 7
    clamped = draws._replace(main_rows=past.main_rows.clamp(max=n_rows - 1), sub_rows=past.sub_rows.clamp(min=0))
    got = trender.render_batch(st, notes, mask, past, cfg)
    assert torch.equal(got, trender.render_batch(st, notes, mask, clamped, cfg))
    assert torch.isfinite(got).all() and got[1:].abs().amax(1).min() > 0.1
    with pytest.raises(ValueError, match="draws for a batch of 3"):
        trender.render_batch(st, notes, mask, RenderDraws(*(x[:2] for x in draws[:5]), draws.fx.take(slice(0, 2))),
                             cfg)
