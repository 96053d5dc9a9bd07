"""The log-mel frontend in fp32: torchaudio's `MelSpectrogram(sample_rate,
n_fft=win_length, hop_length, n_mels, f_min=20, power=2)` (centred STFT,
reflect padding, periodic Hann window, HTK triangular bands with no
normalisation), then log(mel + 1e-10) clamped to [-23, 12] and scaled to
[0, 1], with `window_pad_idxs` frames trimmed from the head and one more
from the tail."""

from __future__ import annotations

import numpy as np
import torch

F_MIN, LOG_FLOOR, CLAMP_LO, CLAMP_HI = 20.0, 1e-10, -23.0, 12.0


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int, f_min: float = F_MIN) -> np.ndarray:
    """(n_freqs, n_mels) HTK triangular bands up to Nyquist."""
    freqs = np.linspace(0, sample_rate // 2, n_freqs)
    f_pts = _mel_to_hz(np.linspace(_hz_to_mel(f_min), _hz_to_mel(sample_rate / 2.0), n_mels + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def pad_frames(win_length: int, hop: int) -> int:
    return int((win_length / 2) // hop + 1)


def out_frames(samples: int, win_length: int, hop: int) -> int:
    return 1 + samples // hop - 2 * pad_frames(win_length, hop) - 1


def log_mel(wave: torch.Tensor, sample_rate: int, win_length: int, hop: int, n_mels: int) -> torch.Tensor:
    """(B, T) wave -> (B, frames, n_mels) fp32 log-mel on the wave's device."""
    wave = wave.float()
    n = torch.arange(win_length, dtype=torch.float64, device=wave.device)
    window = (0.5 - 0.5 * torch.cos(2.0 * np.pi * n / win_length)).float()
    fb = torch.from_numpy(mel_filterbank(win_length // 2 + 1, n_mels, sample_rate)).to(wave.device)
    pad = win_length // 2
    padded = torch.nn.functional.pad(wave[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = padded.unfold(-1, win_length, hop)[:, : 1 + wave.shape[-1] // hop] * window
    spec = torch.fft.rfft(frames, n=win_length, dim=-1)
    mel = torch.matmul(spec.real ** 2 + spec.imag ** 2, fb)
    out = (torch.clamp(torch.log(mel + LOG_FLOOR), CLAMP_LO, CLAMP_HI) - CLAMP_LO) / (CLAMP_HI - CLAMP_LO)
    p = pad_frames(win_length, hop)
    return out[:, p : out.shape[1] - (p + 1), :]
