"""The port's log-mel frontend against the JAX package's, on the CPU.

- the plain rfft path (`adt_str_tpu_torch.ops.mel.log_mel_spectrogram`)
  against `adt_str_tpu.ops.mel.log_mel_spectrogram`;
- the plain K1 (`ops.cuda_mel.log_mel_plain`, which the kernel wrapper runs
  for CPU tensors) against `pallas_log_mel(..., interpret=True)` and against
  the XLA path at the Pallas kernel's own bound.

Inputs are made with numpy from a seed and fed to both sides; the params
are those of `tests/test_pallas_mel.py`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adt_str_tpu.ops import mel as jmel
from adt_str_tpu.ops.pallas_mel import pallas_log_mel
from adt_str_tpu_torch.ops import cuda_mel
from adt_str_tpu_torch.ops import mel as tmel

KW = dict(sample_rate=8000, win_length=512, hop_length=80, n_mels=64)


@pytest.fixture(scope="module")
def wave():
    rng = np.random.default_rng(0)
    t = np.arange(int(1.28 * 8000)) / 8000
    w0 = 0.6 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.normal(size=t.shape)
    w1 = rng.normal(size=t.shape) * 0.1
    return np.stack([w0, w1]).astype(np.float32)


MODES = [("norm", True), ("norm", False), ("db", True), ("db", False)]
# Tolerances. "norm": both sides are fp32 and differ only in FFT/summation
# order (~1e-6 relative), which the [0, 1] scaling (1/35 per log unit) keeps
# below 1e-5. "db": 10*log10 of the same ~1e-6 relative error, larger where
# a band's power is tiny, stays below 2e-4 dB.
TOL = {"norm": 1e-5, "db": 2e-4}


@pytest.mark.parametrize("mode, trim", MODES)
def test_plain_rfft_matches_jax(wave, mode, trim):
    ref = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(wave), jmel.MelFrontendParams(**KW, log_mode=mode), trim=trim))
    out = tmel.log_mel_spectrogram(torch.from_numpy(wave), tmel.MelFrontendParams(**KW, log_mode=mode), trim).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=TOL[mode], rtol=0)


@pytest.mark.parametrize("mode, trim", MODES)
def test_plain_k1_matches_pallas_interpret(wave, mode, trim):
    """Same bf16 frames and bases, fp32 accumulation on both sides: only the
    summation order differs (the Pallas kernel sums the mel product over
    three frequency tiles)."""
    ref = np.asarray(
        pallas_log_mel(jnp.asarray(wave), jmel.MelFrontendParams(**KW, log_mode=mode), trim=trim, interpret=True)
    )
    out = cuda_mel.log_mel_plain(torch.from_numpy(wave), tmel.MelFrontendParams(**KW, log_mode=mode), trim).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=TOL[mode], rtol=0)


def test_plain_k1_matches_xla_at_pallas_bound(wave):
    """bf16 DFT bases against the fp32 rfft: the Pallas kernel's own bound
    (tests/test_pallas_mel.py): 1e-2 worst, 5e-4 mean on [0, 1]."""
    ref = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(wave), jmel.MelFrontendParams(**KW)))
    out = cuda_mel.log_mel_plain(torch.from_numpy(wave), tmel.MelFrontendParams(**KW)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-2, rtol=0)
    assert np.abs(out - ref).mean() < 5e-4


def test_k1_wrapper_runs_plain_for_cpu_tensors(wave):
    """On a CPU tensor the wrapper is the plain version and launches nothing;
    silence maps to exactly 0 (log floor clamped to the bottom)."""
    params = tmel.MelFrontendParams(**KW)
    before = cuda_mel.log_mel.launches
    out = cuda_mel.log_mel(torch.from_numpy(wave), params)
    assert cuda_mel.log_mel.launches == before
    assert torch.equal(out, cuda_mel.log_mel_plain(torch.from_numpy(wave), params))
    silent = cuda_mel.log_mel(torch.zeros(1, wave.shape[1]), params)
    assert silent.abs().max().item() == 0.0


def test_frontend_tables_match_jax():
    np.testing.assert_array_equal(tmel.hann_window_periodic(512), jmel.hann_window_periodic(512))
    np.testing.assert_array_equal(tmel.mel_filterbank(1025, 128, 24000), jmel.mel_filterbank(1025, 128, 24000))
    p = tmel.MelFrontendParams(sample_rate=24000, win_length=2048, hop_length=240, n_mels=128)
    j = jmel.MelFrontendParams(sample_rate=24000, win_length=2048, hop_length=240, n_mels=128)
    assert (p.window_pad_idxs, p.n_frames(61440), p.out_frames(61440)) == (
        j.window_pad_idxs, j.n_frames(61440), j.out_frames(61440))
