"""The synthesiser's render in fp32: note lists and their draws -> audio.

Each of the 27 drum-pitch slots (35..61) blends its main and sub timbre,
`(1 - lam) main + lam sub`, peak-normalised; each sounding note adds its
slot's blend at its onset (the f32 product `onset_s * sr` truncated), scaled
by the velocity curve and the class gain (0.7 for hi-hats, cymbals and
auxiliary percussion); the FX chain runs on the rows that drew it, within a
budget of mean + 6 sigma of Binomial(B, p) rows taken FX rows first; each
row is peak-normalised to the gain of its loudest velocity, and rows with
no sounding note are silent."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from benchmark.reference.fx import fx_chain

PITCH_LO, PITCH_HI = 35, 61
N_SLOTS = PITCH_HI - PITCH_LO + 1
QUIET_PITCHES = (42, 43, 44, 46, 48, 49, 50, 51, 52, 58)  # class gain 0.7


def class_gain(device) -> torch.Tensor:
    g = torch.ones(128, device=device)
    g[list(QUIET_PITCHES)] = 0.7
    return g


def vel_to_vol(velocity: torch.Tensor) -> torch.Tensor:
    v = torch.clamp(velocity, 0.0, 127.0) / 127.0
    vol = 0.1 + 0.9 * (torch.pow(6.0, v) - 1.0) / 5.0
    return torch.where(velocity == 0, 0.0, vol)


def fx_budget(batch: int, p: float) -> int:
    p = min(max(float(p), 0.0), 1.0)
    if p <= 0:
        return 0
    return min(batch, int(np.ceil(batch * p + 6.0 * np.sqrt(batch * p * (1.0 - p)))))


def note_gains(notes, mask, slot_ok, peak, sample_rate: int, chunk: int):
    """-> (slot, onset, gain) of each note: gain folds in the velocity, the
    class gain, the slot's validity and its blend's peak."""
    pitch = torch.clamp(notes[..., 2].to(torch.int32), 0, 127).long()
    onset = torch.clamp((notes[..., 0] * sample_rate).to(torch.int32), 0, chunk - 1).long()
    slot = torch.clamp(pitch - PITCH_LO, 0, N_SLOTS - 1)
    gain = vel_to_vol(notes[..., 3]) * class_gain(notes.device)[pitch]
    gain = torch.where(mask & (pitch >= PITCH_LO) & (pitch <= PITCH_HI), gain, 0.0)
    gain = gain * torch.gather(slot_ok, 1, slot).float() / torch.gather(peak, 1, slot)
    return slot, onset, gain


def render(bank: torch.Tensor, notes: torch.Tensor, mask: torch.Tensor, draws, sample_rate: int, chunk: int,
           use_fx_prob: float) -> torch.Tensor:
    """(n_rows, L) bank, (B, N, 4) [onset s, offset s, pitch, velocity]
    notes, (B, N) mask and the draws (main_rows, sub_rows, slot_ok, lam,
    use_fx and `fx`, a dict of the FX parameters) -> (B, chunk) fp32 audio."""
    B = notes.shape[0]
    L = bank.shape[1]
    lam = draws.lam.float()[..., None]
    blend = (1.0 - lam) * bank[draws.main_rows].float() + lam * bank[draws.sub_rows].float()  # (B, 27, L)
    peak = torch.clamp_min(blend.abs().amax(-1), 1e-8)
    slot, onset, gain = note_gains(notes.float(), mask, draws.slot_ok, peak, sample_rate, chunk)
    buf = torch.zeros(B, chunk + L, device=notes.device)
    rows = torch.arange(B, device=notes.device)
    pos = torch.arange(L, device=notes.device)
    for n in range(slot.shape[1]):
        buf.scatter_add_(1, onset[:, n : n + 1] + pos, gain[:, n : n + 1] * blend[rows, slot[:, n]])
    wav = buf[:, :chunk]
    if use_fx_prob > 0.0:
        budget = fx_budget(B, use_fx_prob)
        if budget >= B or B <= 8:
            idx = torch.arange(B, device=notes.device)
        else:
            idx = torch.argsort((~draws.use_fx).to(torch.int8), stable=True)[:budget]
        fx = SimpleNamespace(**{k: v[idx] for k, v in draws.fx.items()})
        sub = wav[idx]
        wav = wav.index_copy(0, idx, torch.where(draws.use_fx[idx][:, None], fx_chain(sub, sample_rate, fx), sub))
    master = vel_to_vol(torch.where(mask, notes[..., 3].float(), 0.0).amax(1))
    wav = wav / torch.clamp_min(wav.abs().amax(1, keepdim=True), 1e-8) * master[:, None]
    return torch.where((mask & (gain > 0)).any(1)[:, None], wav, 0.0)
