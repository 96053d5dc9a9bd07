"""Log-mel spectrogram frontend, plain PyTorch path.

Port of `adt_str_tpu/ops/mel.py` (`hann_window_periodic`, `mel_filterbank`,
`MelFrontendParams`, `frame_signal`, `log_mel_spectrogram`). It computes
what torchaudio's `MelSpectrogram(sample_rate, n_fft=win_length,
hop_length, n_mels, f_min=20, power=2)` computes: centered STFT with reflect
padding, periodic Hann window, HTK triangular filterbank (norm=None); then
log(mel + 1e-10), clamp [-23, 12] and scale to [0, 1] ("norm"), or
10*log10(max(mel, 1e-10)) ("db"); then trim `window_pad_idxs` frames from
the head and one more from the tail.

The whole frontend runs in float32 (an rfft, then a float32 matmul) whatever
the model's compute dtype. The fused kernel of the same function is
`ops/cuda_mel.py`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def hann_window_periodic(win_length: int) -> np.ndarray:
    """Periodic Hann window, identical to torch.hann_window(periodic=True)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(
    n_freqs: int,
    n_mels: int,
    sample_rate: int,
    f_min: float = 20.0,
    f_max: float | None = None,
) -> np.ndarray:
    """(n_freqs, n_mels) HTK triangular filterbank, norm=None (torchaudio's
    `melscale_fbanks` defaults)."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down_slopes = -slopes[:, :-2] / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    return fb.astype(np.float32)


@dataclass(frozen=True)
class MelFrontendParams:
    """Static constants of the frontend.

    `log_mode`: "norm" (ln, clamp, scale to [0, 1]: the ADT model's input)
    or "db" (10*log10(max(mel, floor)): the CLAP chain)."""

    sample_rate: int
    win_length: int
    hop_length: int
    n_mels: int
    f_min: float = 20.0
    f_max: float | None = None
    log_floor: float = 1e-10
    clamp_lo: float = -23.0
    clamp_hi: float = 12.0
    log_mode: str = "norm"

    @property
    def n_fft(self) -> int:
        return self.win_length

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def window_pad_idxs(self) -> int:
        return int((self.win_length / 2) // self.hop_length + 1)

    def n_frames(self, n_samples: int) -> int:
        # centered STFT: 1 + n_samples // hop
        return 1 + n_samples // self.hop_length

    def out_frames(self, n_samples: int) -> int:
        return self.n_frames(n_samples) - 2 * self.window_pad_idxs - 1


def frame_signal(wave: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, T) -> (B, n_frames, n_fft) centered frames with reflect padding."""
    pad = n_fft // 2
    padded = torch.nn.functional.pad(wave[:, None, :], (pad, pad), mode="reflect")[:, 0]
    return padded.unfold(-1, n_fft, hop)[:, : 1 + wave.shape[-1] // hop]


def log_mel_spectrogram(
    wave: torch.Tensor, params: MelFrontendParams, trim: bool = True
) -> torch.Tensor:
    """(B, T) float wave -> (B, frames, n_mels) log-mel, on `wave`'s device."""
    wave = wave.to(torch.float32)
    window = torch.from_numpy(hann_window_periodic(params.win_length)).to(wave.device)
    fb = torch.from_numpy(
        mel_filterbank(params.n_freqs, params.n_mels, params.sample_rate, params.f_min, params.f_max)
    ).to(wave.device)
    frames = frame_signal(wave, params.n_fft, params.hop_length) * window
    spec = torch.fft.rfft(frames, n=params.n_fft, dim=-1)
    power = spec.real**2 + spec.imag**2
    mel = torch.matmul(power, fb)
    if params.log_mode == "db":
        logmel = 10.0 * torch.log10(torch.clamp(mel, min=params.log_floor))
    else:
        logmel = torch.clamp(torch.log(mel + params.log_floor), params.clamp_lo, params.clamp_hi)
        logmel = (logmel - params.clamp_lo) / (params.clamp_hi - params.clamp_lo)
    if trim:
        p = params.window_pad_idxs
        logmel = logmel[:, p : logmel.shape[1] - (p + 1), :]
    return logmel
