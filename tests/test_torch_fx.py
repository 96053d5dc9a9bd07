"""The port's FX chain (`adt_str_tpu_torch/synth/fx.py`) against the JAX
package's (`adt_str_tpu/synth/fx.py`), on the CPU.

The port runs batched rows with per-row parameters; JAX runs each row
(vmapped). Inputs are made with numpy from a seed. Tolerance: 1e-5 of the
input signal's peak everywhere. Both sides compute in fp32 with the same
algorithm; the products sum in other orders, the 30-step bisection of the
band decays may end an ulp apart, and `linspace` may differ by an ulp.
The JAX side runs jitted (one compile each; eager dispatch of the reverb's
graph takes ten times as long).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adt_str_tpu.synth import fx as jfx
from adt_str_tpu_torch.synth import fx as tfx

SR = 8000
N = SR  # one second


def _signal(rows=3, seed=0) -> np.ndarray:
    """Decaying noise bursts at other onsets per row (drum-like), peak ~0.6-0.9."""
    rng = np.random.default_rng(seed)
    sig = np.zeros((rows, N), np.float32)
    for r in range(rows):
        for t0 in rng.uniform(0, 0.8, 4):
            i, L = int(t0 * SR), 1500
            sig[r, i : i + L] += (np.exp(-np.arange(L) / 300) * rng.normal(size=L) * 0.3).astype(np.float32)
    return sig


def _close(got: torch.Tensor, ref, x: np.ndarray) -> None:
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(x).max(), rtol=0)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_fx_draws(keys, use_reverb_prob, use_compression_prob, use_limiter_prob):
    def one(key):
        k = jax.random.split(key, 10)
        _, k_width = jax.random.split(k[6])
        k_a, k_r, k_l = jax.random.split(k[9], 3)
        dcn = jfx.draw_clamped_normal
        return (
            jax.random.uniform(k[0]) < use_reverb_prob,
            jax.random.uniform(k[1]) < use_compression_prob,
            jax.random.uniform(k[2]) < use_limiter_prob,
            jax.random.uniform(k[3], minval=0.2, maxval=0.8),
            jax.random.uniform(k[4], minval=0.2, maxval=0.8),
            jax.random.uniform(k[5], minval=0.1, maxval=0.4),
            jax.random.uniform(k_width, minval=0.6, maxval=1.0),
            -dcn(k[7], 0.15, 0.5, 10.0, 0.0),
            dcn(k[8], 0.15, 0.5, 10.0, 1.0),
            dcn(k_a, 0.05, 0.1, 1000.0, 0.0),
            dcn(k_r, 0.15, 0.2, 1000.0, 0.0),
            -dcn(k_l, 0.2, 0.4, 3.0, 0.0),
        )

    return jax.vmap(one)(keys)


def jax_fx_params(keys, use_reverb_prob, use_compression_prob, use_limiter_prob) -> tfx.FxParams:
    """The parameters JAX's `random_fx_chain` draws from each row's key,
    replaying its key splits (`fx.py:515-539`), as the port's `FxParams`."""
    draws = _jax_fx_draws(keys, use_reverb_prob, use_compression_prob, use_limiter_prob)
    return tfx.FxParams(*(torch.from_numpy(np.array(a)) for a in draws))


def test_ema_scan_matches_jax():
    x = np.abs(_signal(seed=1))
    coeff = np.array([0.0, 0.5, 0.995], np.float32)
    ema = jax.jit(jax.vmap(jfx.ema_scan))
    _close(tfx.ema_scan(torch.from_numpy(x), torch.from_numpy(coeff)), ema(jnp.asarray(x), jnp.asarray(coeff)), x)
    # a coefficient shared by every row
    _close(tfx.ema_scan(torch.from_numpy(x), 0.9), ema(jnp.asarray(x), jnp.full(3, 0.9, jnp.float32)), x)


def test_compressor_and_limiter_match_jax():
    x = _signal(seed=2)
    thr, ratio = np.array([-20.0, -10.0, -3.0], np.float32), np.array([8.0, 2.0, 1.0], np.float32)
    att, rel = np.array([1.0, 0.0, 30.0], np.float32), np.array([50.0, 0.5, 400.0], np.float32)
    ref = jax.jit(jax.vmap(lambda *a: jfx.compressor(a[0], SR, *a[1:])))(*map(jnp.asarray, (x, thr, ratio, att, rel)))
    got = tfx.compressor(*map(torch.from_numpy, (x,)), SR, *map(torch.from_numpy, (thr, ratio, att, rel)))
    _close(got, ref, x)
    lim = np.array([-6.0, -1.0, 0.0], np.float32)
    ref = jax.jit(jax.vmap(lambda a, t: jfx.limiter(a, SR, t)))(jnp.asarray(x * 2), jnp.asarray(lim))
    _close(tfx.limiter(torch.from_numpy(x * 2), SR, torch.from_numpy(lim)), ref, x * 2)


_jax_reverb = jax.jit(jax.vmap(lambda *a: jfx.reverb(a[0], SR, *a[1:])))


@pytest.mark.parametrize("damping", ["zero", "sampled"])
def test_reverb_matches_jax(damping):
    x = _signal(seed=3)
    rng = np.random.default_rng(4)
    room = rng.uniform(0.2, 0.8, 3).astype(np.float32)
    damp = np.zeros(3, np.float32) if damping == "zero" else rng.uniform(0.2, 0.8, 3).astype(np.float32)
    wet = rng.uniform(0.1, 0.4, 3).astype(np.float32)
    width = rng.uniform(0.6, 1.0, 3).astype(np.float32)
    ref = _jax_reverb(*map(jnp.asarray, (x, room, damp, wet, width)))
    got = tfx.reverb(torch.from_numpy(x), SR, *map(torch.from_numpy, (room, damp, wet, width)))
    _close(got, ref, x)
    assert np.abs(got.numpy() - x).max() > 1e-3  # the reverb did something


@pytest.mark.parametrize("probs", [(1.0, 1.0, 1.0), (0.5, 0.5, 0.5)], ids=["all", "half"])
def test_fx_chain_given_jax_draws_matches_jax(probs):
    x = _signal(rows=6, seed=5)
    keys = jax.random.split(jax.random.PRNGKey(7), 6)
    ref = jax.jit(jax.vmap(lambda r, k: jfx.random_fx_chain(r, SR, k, *probs)))(jnp.asarray(x), keys)
    params = jax_fx_params(keys, *probs)
    _close(tfx.fx_chain(torch.from_numpy(x), SR, params), ref, x)
    if probs[0] < 1:
        assert 0 < int(params.use_reverb.sum()) < 6  # both branches of the selects ran


def test_fx_products_are_fp32_and_restore_the_callers_setting(monkeypatch):
    """The chain runs its products with TF32 off and leaves the caller's
    matmul precision as it found it."""
    seen = []
    orig = torch.matmul

    def spy(a, b):
        seen.append(torch.get_float32_matmul_precision())
        return orig(a, b)

    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        monkeypatch.setattr(torch, "matmul", spy)
        tfx.fx_chain(torch.from_numpy(_signal(rows=2)), SR,
                     jax_fx_params(jax.random.split(jax.random.PRNGKey(0), 2), 1.0, 1.0, 1.0))
        monkeypatch.undo()
        assert seen and set(seen) == {"highest"}
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
