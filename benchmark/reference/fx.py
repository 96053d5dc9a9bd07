"""The synthesiser's randomized FX chain (reverb, compressor, limiter) on
batched rows, in fp32: a frozen copy of the algorithms the port runs
(Freeverb's topology with band-matched damping, JUCE ballistics, JUCE's
limiter), kept here so the reference takes nothing from the program. Every
product is true fp32 (TF32 off while it runs)."""


from __future__ import annotations

import functools
import math
from typing import Union

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import true_fp32


def fp32_products(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with true_fp32():
            return fn(*args, **kwargs)

    return wrapped

# Freeverb tunings at 44100 Hz (Jezar's constants, used verbatim by JUCE
# Reverb) and JUCE parameter scalings.
COMB_TUNINGS_44K = (1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617)
ALLPASS_TUNINGS_44K = (556, 441, 341, 225)
FIXED_GAIN = 0.015
FREEVERB_ROOM_SCALE, FREEVERB_ROOM_OFFSET = 0.28, 0.7
DAMP_SCALE = 0.4
WET_SCALE, DRY_SCALE = 3.0, 2.0
_DAMP_FIR_TAPS = 16  # damping pole <= 0.32 => 0.32^16 ~ 1e-8
_N_GRID = 256  # frequency grid for the band-energy quadrature
# cascade orders of the damping one-pole used as band-split filters (bands
# H^8, H^4-H^8, H^2-H^4, H^1-H^2, 1-H^1) and the taps of each analytic kernel
_CASCADE_ORDERS = (1, 2, 4, 8)
_CASCADE_TAPS = (16, 20, 28, 40)
# wet-path spectral-correction pole q = a + b*d + c*fb
_Q_FIT = (-0.3522, 0.0774, 0.5271)
_T20_BISECT_ITERS = 30
_FIR_BLOCK = 128
_PEAK_WINDOW = 12  # causal sliding-max width of the envelope

Param = Union[float, torch.Tensor]


def _col(p: Param, x: torch.Tensor) -> torch.Tensor:
    """A per-row parameter as an (R, 1) f32 column (a number: the same for every row)."""
    t = torch.as_tensor(p, dtype=torch.float32, device=x.device)
    return t.reshape(-1, 1) if t.dim() else t.reshape(1, 1)


@fp32_products
def ema_scan(x: torch.Tensor, coeff: Param, block: int = 128) -> torch.Tensor:
    """First-order IIR y[t] = c*y[t-1] + (1-c)*x[t] along each row of (R, n)
    x, exactly and scan-free: y = blocks(x) @ A(c)^T plus carries, with
    A[i, j] = (1-c) c^(i-j) and the carries entering each block solved by a
    second lower-triangular product. `coeff`: (R,) or a number in [0, 1)."""
    r, n = x.shape
    nb = -(-n // block)
    xb = F.pad(x, (0, nb * block - n)).reshape(r, nb, block)
    logc = torch.log(torch.clamp_min(_col(coeff, x), 1e-30))[..., None]  # (R|1, 1, 1)
    one_minus = 1.0 - _col(coeff, x)[..., None]
    i = torch.arange(block, dtype=torch.float32, device=x.device)
    delta = i[:, None] - i[None, :]
    a_mat = torch.where(delta >= 0, one_minus * torch.exp(delta * logc), 0.0)  # (R|1, block, block)
    y_local = torch.matmul(xb, a_mat.transpose(-1, -2))  # (R, nb, block)
    last = y_local[:, :, -1:]  # (R, nb, 1)
    b = torch.arange(nb, dtype=torch.float32, device=x.device)
    e = b[:, None] - 1 - b[None, :]
    t_mat = torch.where(e >= 0, torch.exp(e * (block * logc)), 0.0)  # (R|1, nb, nb)
    carries = torch.matmul(t_mat, last)  # (R, nb, 1)
    decay = torch.exp((i + 1) * logc)  # (R|1, 1, block)
    y = y_local + decay * carries
    return y.reshape(r, nb * block)[:, :n]


# ------------------------------------------------------- freeverb machinery


def _retuned(t44: int, sr: int) -> int:
    """JUCE Reverb::setSampleRate retunes with INTEGER division."""
    return max(1, (t44 * int(sr)) // 44100)


def _blocks(x: torch.Tensor, length: int) -> torch.Tensor:
    """(..., n) -> (..., nb, L): block k, phase p holds x[k*L + p] (end-padded)."""
    n = x.shape[-1]
    nb = -(-n // length)
    return F.pad(x, (0, nb * length - n)).reshape(*x.shape[:-1], nb, length)


def _comb_bank(bands: torch.Tensor, length: int, log_fbs: torch.Tensor) -> torch.Tensor:
    """Exact feedback combs y[t] = x[t-L] + fb*y[t-L] (zero initial state)
    summed over the damping bands: (R, 5, n) bands with (R, 5) log
    feedbacks -> (R, n). Per band the phase-decomposed closed form is a
    strictly lower-triangular (nb, nb) operator; the band sum is folded into
    one product contracting (band, source block) together."""
    r, nbands, n = bands.shape
    xb = _blocks(bands, length)  # (R, 5, nb, L)
    nb = xb.shape[2]
    k = torch.arange(nb, dtype=torch.float32, device=bands.device)
    e = k[:, None] - 1 - k[None, :]
    t = torch.where(e >= 0, torch.exp(e * log_fbs[:, :, None, None]), 0.0)  # (R, 5, nb, nb)
    t = t.permute(0, 2, 1, 3).reshape(r, nb, nbands * nb)
    y = torch.matmul(t, xb.reshape(r, nbands * nb, length))  # (R, nb, L)
    return y.reshape(r, nb * length)[:, :n]


@functools.lru_cache(maxsize=None)
def _allpass_matrix(nb: int) -> np.ndarray:
    """Blocked operator for the Freeverb allpass (feedback 0.5):
    y[k] = -x[k] + sum_{m<k} 0.5^(k-1-m) x[m]."""
    k = np.arange(nb)
    e = k[:, None] - 1 - k[None, :]
    t = np.where(e >= 0, 0.5 ** np.maximum(e, 0), 0.0) - np.eye(nb)
    return t.astype(np.float32)


def _allpass(x: torch.Tensor, length: int) -> torch.Tensor:
    n = x.shape[-1]
    xb = _blocks(x, length)  # (R, nb, L)
    t_mat = torch.from_numpy(_allpass_matrix(xb.shape[1])).to(x.device)
    return torch.matmul(t_mat, xb).reshape(x.shape[0], -1)[:, :n]


def _causal_fir(x: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """y_c[t] = sum_j kernels[c, j] * x[t-j] (zero history) for every
    channel c of every row, as one banded block product: the row is windowed
    into (nb, W-1+S) slabs (each S-block plus the W-1 samples before it)
    times a (W-1+S, C*S) tap matrix. x: (R, n), kernels: (R, C, W) ->
    (R, C, n). The degenerate kernel (1, 0, ...) reproduces x exactly."""
    r, n = x.shape
    c, w = kernels.shape[1:]
    s = _FIR_BLOCK
    assert w - 1 <= s, "kernel longer than the block's backward window"
    nb = -(-n // s)
    xp = F.pad(x, (w - 1, nb * s - n))
    main = xp[:, w - 1 :].reshape(r, nb, s)
    prev = xp[:, : nb * s].reshape(r, nb, s)[:, :, : w - 1]
    xw = torch.cat([prev, main], dim=2)  # (R, nb, W-1+S)
    i = torch.arange(w - 1 + s, device=x.device)[:, None]  # window position
    o = torch.arange(s, device=x.device)[None, :]  # output position within the block
    j = (o + w - 1) - i  # tap feeding (i, o)
    valid = (j >= 0) & (j < w)
    jc = torch.clamp(j, 0, w - 1)
    t_mat = torch.where(valid, kernels[:, :, jc.reshape(-1)].reshape(r, c, w - 1 + s, s), 0.0)
    t2 = t_mat.permute(0, 2, 1, 3).reshape(r, w - 1 + s, c * s)
    y = torch.matmul(xw, t2).reshape(r, nb, c, s)
    return y.permute(0, 2, 1, 3).reshape(r, c, nb * s)[:, :, :n]


def _identity_taps(taps: int, device) -> torch.Tensor:
    k = torch.zeros(taps, dtype=torch.float32, device=device)
    k[0] = 1.0
    return k


def _onepole_lp(x: torch.Tensor, pole: torch.Tensor) -> torch.Tensor:
    """One-pole low-pass y[t] = (1-p)x[t] + p y[t-1] per row, as a 16-tap FIR
    (exact to ~1e-8 for poles <= ~0.35); pole 0 is the identity."""
    pole = pole[:, None]
    i = torch.arange(_DAMP_FIR_TAPS, dtype=torch.float32, device=x.device)
    kernel = (1.0 - pole) * torch.pow(torch.clamp_min(pole, 1e-12), i)
    kernel = torch.where(pole <= 1e-12, _identity_taps(_DAMP_FIR_TAPS, x.device), kernel)
    return _causal_fir(x, kernel[:, None, :])[:, 0]


@functools.lru_cache(maxsize=None)
def _cascade_binoms() -> tuple[np.ndarray, ...]:
    """Negative-binomial coefficients C(i+k-1, i) of the analytic k-fold
    one-pole kernel (LP^k)[i] = (1-d)^k C(i+k-1, i) d^i, one row per order."""
    out = []
    for order, taps in zip(_CASCADE_ORDERS, _CASCADE_TAPS):
        i = np.arange(taps)
        c = np.ones(taps)
        for j in range(1, order):
            c = c * (i + j) / j
        out.append(c.astype(np.float64))
    return tuple(out)


def _cascade_lowpasses(x: torch.Tensor, d: torch.Tensor) -> list[torch.Tensor]:
    """[LP^1(x), LP^2(x), LP^4(x), LP^8(x)] per row as one 4-channel causal
    FIR of truncated analytic kernels; at d == 0 every kernel is the identity."""
    max_taps = max(_CASCADE_TAPS)
    dd = d[:, None]
    zero = dd <= 1e-12
    i = torch.arange(max_taps, dtype=torch.float32, device=x.device)
    d_pow = torch.where(zero, _identity_taps(max_taps, x.device), torch.pow(torch.clamp_min(dd, 1e-12), i))
    rows = []
    for order, taps, binom in zip(_CASCADE_ORDERS, _CASCADE_TAPS, _cascade_binoms()):
        b = torch.as_tensor(binom, dtype=torch.float32, device=x.device)
        k = b * d_pow[:, :taps] * (1.0 - dd) ** order
        k = torch.where(zero, _identity_taps(taps, x.device), k)
        rows.append(F.pad(k, (0, max_taps - taps)))
    out = _causal_fir(x, torch.stack(rows, dim=1))  # (R, 4, n)
    return [out[:, b] for b in range(len(_CASCADE_ORDERS))]


def _band_gains_decay(d: torch.Tensor, fb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row and band, the per-pass feedback gain a_b and input gain g_b,
    each (R, 5): a_b matches the band's Schroeder T20 decay rate (the -5 and
    -25 dB backward-integral pass counts, bisected jointly on a 256-point
    frequency grid), g_b restores the band's steady-state energy. Empty
    bands and d == 0 pin both to 1 (exact Freeverb)."""
    theta = torch.linspace(1e-4, math.pi, _N_GRID, dtype=torch.float32, device=d.device)
    dd, fbc = d[:, None], fb[:, None]
    hre = 1.0 - dd * torch.cos(theta)
    him = -dd * torch.sin(theta)
    den = hre * hre + him * him
    mag = (1.0 - dd) / torch.sqrt(den)
    ang = -torch.atan2(him, hre)
    mag2 = mag * mag
    rows = []
    prev_re = prev_im = None
    for o in (8, 4, 2, 1, 0):  # F_b = H^orders[b] - H^orders[b-1]
        if o == 0:
            re, im = torch.ones_like(mag), torch.zeros_like(mag)
        else:
            re = mag**o * torch.cos(o * ang)
            im = mag**o * torch.sin(o * ang)
        rows.append(re * re + im * im if prev_re is None else (re - prev_re) ** 2 + (im - prev_im) ** 2)
        prev_re, prev_im = re, im
    w = torch.stack(rows, dim=1)  # (R, 5, N_GRID)
    wsum = torch.clamp_min(w.sum(2), 1e-30)

    fb2 = fbc * fbc
    g = torch.log(torch.clamp_min(fb2 * mag2, 1e-30))  # (R, N_GRID) < 0
    inv_neg_g = 1.0 / torch.clamp_min(-g, 1e-12)
    s0 = torch.clamp_min((w * inv_neg_g[:, None, :]).sum(2), 1e-30)  # (R, 5)

    targets = torch.tensor([10.0 ** (-0.5), 10.0 ** (-2.5)], dtype=torch.float32, device=d.device)
    lo = torch.zeros(*w.shape[:2], 2, dtype=torch.float32, device=d.device)
    hi = torch.full_like(lo, 4000.0)
    for _ in range(_T20_BISECT_ITERS):
        mid = 0.5 * (lo + hi)  # (R, 5, 2)
        s_mid = (w[:, :, None, :] * torch.exp(mid[..., None] * g[:, None, None, :])
                 * inv_neg_g[:, None, None, :]).sum(3)
        still_above = (s_mid / s0[..., None]) > targets
        lo = torch.where(still_above, mid, lo)
        hi = torch.where(still_above, hi, mid)
    m = 0.5 * (lo + hi)
    dm = torch.clamp_min(m[..., 1] - m[..., 0], 1e-6)
    a_b = torch.exp(-math.log(10.0) / dm) / torch.clamp_min(fbc, 1e-6)
    a_b = torch.clamp(a_b, 0.0, 1.0)

    e_true = (w / (1.0 - fb2 * mag2)[:, None, :]).sum(2) / wsum  # (R, 5)
    g_b = torch.sqrt(torch.clamp_min(e_true * (1.0 - fb2 * a_b * a_b), 0.0))

    pin = (w.sum(2) <= 1e-20) | (dd <= 1e-12)
    return torch.where(pin, 1.0, a_b), torch.where(pin, 1.0, g_b)


@fp32_products
def reverb(x: torch.Tensor, sr: int, room_size: Param, damping: Param, wet_level: Param,
           width: Param = 1.0) -> torch.Tensor:
    """Freeverb / JUCE Reverb, mono, on (R, n) rows with per-row parameters:
    8 parallel combs (feedback 0.28*room + 0.7) fed by the five damping
    bands, 4 series allpasses, the wet correction pole, and JUCE's mono mix
    (input gain 0.015, dry 2*(1-wet), wet 3*wet*(width/2+0.5))."""
    r = x.shape[0]
    fb = (FREEVERB_ROOM_SCALE * _col(room_size, x) + FREEVERB_ROOM_OFFSET).expand(r, 1)[:, 0]
    d = (DAMP_SCALE * _col(damping, x)).expand(r, 1)[:, 0]
    l1, l2, l4, l8 = _cascade_lowpasses(x, d)
    bands = torch.stack([l8, l4 - l8, l2 - l4, l1 - l2, x - l1], dim=1)  # (R, 5, n)
    a_b, g_b = _band_gains_decay(d, fb)
    bands = bands * g_b[..., None]
    log_fbs = torch.log(fb)[:, None] + torch.log(torch.clamp_min(a_b, 1e-12))  # (R, 5)
    wet = torch.zeros_like(x)
    for t44 in COMB_TUNINGS_44K:
        wet = wet + _comb_bank(bands, _retuned(t44, sr), log_fbs)
    for t44 in ALLPASS_TUNINGS_44K:
        wet = _allpass(wet, _retuned(t44, sr))
    qa, qb, qc = _Q_FIT
    q = torch.clamp(qa + qb * d + qc * fb, 0.0, 0.35)
    q = q * torch.clamp(d / (DAMP_SCALE * 0.2), 0.0, 1.0)  # ramp: exact at d = 0
    wet = _onepole_lp(wet, q)
    wet_level = _col(wet_level, x)
    wet_gain = WET_SCALE * wet_level * (_col(width, x) / 2.0 + 0.5)
    return DRY_SCALE * (1.0 - wet_level) * x + wet_gain * FIXED_GAIN * wet


# ------------------------------------------------------ dynamics machinery


def _ballistics_coeff(sr: int, time_ms: torch.Tensor) -> torch.Tensor:
    """JUCE BallisticsFilter coefficient exp(-2*pi*1000/(sr*ms)); times
    below 1e-3 ms give 0 (instant)."""
    cte = torch.exp(-2.0 * math.pi * 1000.0 / (sr * torch.clamp_min(time_ms, 1e-3)))
    return torch.where(time_ms < 1e-3, 0.0, cte)


def _sliding_max(x: torch.Tensor, w: int) -> torch.Tensor:
    """Causal sliding max over the trailing `w` samples of each row, by
    doubling shifts (x >= 0: the zero padding never wins)."""
    y = x
    s = 1
    while s < w:
        step = min(s, w - s)
        y = torch.maximum(y, F.pad(y, (step, 0))[..., :-step])
        s += step
    return y


def _envelope(x: torch.Tensor, sr: int, attack_ms: Param, release_ms: Param) -> torch.Tensor:
    """Full-rate peak envelope: causal sliding max of |x|, then attack and
    release EMAs with JUCE ballistics coefficients, max-combined."""
    sm = _sliding_max(torch.abs(x), _PEAK_WINDOW)
    fast = ema_scan(sm, _ballistics_coeff(sr, _col(attack_ms, x))[:, 0])
    slow = ema_scan(sm, _ballistics_coeff(sr, torch.clamp_min(_col(release_ms, x), 1.0))[:, 0])
    return torch.maximum(fast, slow)


@fp32_products
def compressor(x: torch.Tensor, sr: int, threshold_db: Param, ratio: Param, attack_ms: Param,
               release_ms: Param) -> torch.Tensor:
    env = _envelope(x, sr, attack_ms, release_ms)
    env_db = 20.0 * torch.log10(env + 1e-8)
    over_db = torch.clamp_min(env_db - _col(threshold_db, x), 0.0)
    gain_db = over_db * (1.0 / torch.clamp_min(_col(ratio, x), 1.0) - 1.0)
    return x * torch.pow(10.0, gain_db / 20.0)


@fp32_products
def limiter(x: torch.Tensor, sr: int, threshold_db: Param, release_ms: Param = 100.0) -> torch.Tensor:
    """JUCE dsp::Limiter semantics: a fixed 4:1 pre-compressor at -10 dB
    (2/200 ms), a near-infinite-ratio stage at the threshold with instant
    attack, then a hard clamp."""
    y = compressor(x, sr, -10.0, 4.0, 2.0, 200.0)
    env = _envelope(y, sr, attack_ms=0.0, release_ms=release_ms)
    env_db = 20.0 * torch.log10(env + 1e-8)
    gain_db = -torch.clamp_min(env_db - _col(threshold_db, x), 0.0)
    y = y * torch.pow(10.0, gain_db / 20.0)
    return torch.clamp(y, -1.0, 1.0)


# ------------------------------------------------------------- the chain


@fp32_products
def fx_chain(x: torch.Tensor, sr: int, p) -> torch.Tensor:
    """(R, n) rows through reverb -> compressor -> limiter, each where its
    row's flag is set (deterministic given `p`)."""
    y = torch.where(p.use_reverb[:, None], reverb(x, sr, p.room, p.damping, p.wet, p.width), x)
    y = torch.where(p.use_compression[:, None],
                    compressor(y, sr, p.comp_threshold_db, p.comp_ratio, p.comp_attack_ms, p.comp_release_ms), y)
    return torch.where(p.use_limiter[:, None], limiter(y, sr, p.lim_threshold_db), y)
