"""CLAP feature extraction: the fused dB log-mel input of the audio tower.

Port of `adt_str_tpu/clap/features.py`. It replicates HF
`ClapFeatureExtractor` (laion/clap-htsat-fused defaults: 48 kHz, n_fft
1024, hop 480, 64 mels, f_max 14 kHz, dB log-mel, `fusion` truncation,
`repeatpad` padding) in numpy:

- short audio (<= 10 s): repeat + zero-pad to 10 s, one log-mel, stacked
  4x, `is_longer=False`;
- long audio: the full log-mel; 3 random crops (one from each third) and a
  bilinear-shrunk full mel as the 4 channels, `is_longer=True`. The crops
  draw from the extractor's `np.random.Generator` with the same calls as
  the JAX package, so one seed gives the same crops;
- HF's batch quirk (when no item is longer, one random item is flagged
  longer) sits behind `replicate_hf_longer_quirk`, off by default.

`device_log_mel_db` is the batched device path for 10 s inputs, which the
wrapper takes for short clips on a card: K1 (`ops/cuda_mel.log_mel`) at
`_clap_mel_params()` without the trim, the CUDA kernel for a CUDA tensor and
its plain version for a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from adt_str_tpu_torch.ops import cuda_mel
from adt_str_tpu_torch.ops.mel import MelFrontendParams, hann_window_periodic, mel_filterbank

SAMPLE_RATE = 48_000
N_FFT = 1024
HOP = 480
N_MELS = 64
F_MIN = 0.0
F_MAX = 14_000.0
MAX_LENGTH_S = 10
MAX_SAMPLES = MAX_LENGTH_S * SAMPLE_RATE


def _log_mel_db(waveform: np.ndarray, fb: np.ndarray) -> np.ndarray:
    """(T,) -> (frames, 64) dB log-mel in float64 then float32, as HF
    `spectrogram(..., power=2.0, log_mel='dB')`: a centred reflect-padded
    STFT, periodic Hann window, power_to_db with amin 1e-10 and no top_db."""
    window = hann_window_periodic(N_FFT)
    pad = N_FFT // 2
    padded = np.pad(waveform.astype(np.float64), (pad, pad), mode="reflect")
    n_frames = 1 + len(waveform) // HOP
    idx = np.arange(n_frames)[:, None] * HOP + np.arange(N_FFT)[None, :]
    frames = padded[idx] * window
    spec = np.fft.rfft(frames, axis=-1)
    power = np.abs(spec) ** 2  # (frames, 513)
    mel = power @ fb  # (frames, 64)
    return (10.0 * np.log10(np.maximum(mel, 1e-10))).astype(np.float32)


def _bilinear_resize(mel: np.ndarray, out_t: int, out_f: int) -> np.ndarray:
    """align_corners=False bilinear resize (torch F.interpolate's default)."""

    def axis_matrix(n_in, n_out):
        M = np.zeros((n_out, n_in))
        scale = n_in / n_out
        for i in range(n_out):
            x = (i + 0.5) * scale - 0.5
            x0 = int(np.floor(x))
            w = x - x0
            a = min(max(x0, 0), n_in - 1)
            b = min(max(x0 + 1, 0), n_in - 1)
            M[i, a] += 1 - w
            M[i, b] += w
        return M

    Mt = axis_matrix(mel.shape[0], out_t)
    Mf = axis_matrix(mel.shape[1], out_f)
    return (Mt @ mel @ Mf.T).astype(np.float32)


def _clap_mel_params() -> MelFrontendParams:
    return MelFrontendParams(
        sample_rate=SAMPLE_RATE, win_length=N_FFT, hop_length=HOP,
        n_mels=N_MELS, f_min=F_MIN, f_max=F_MAX, log_mode="db",
    )


def device_log_mel_db(waves: torch.Tensor) -> torch.Tensor:
    """(B, 480000) 10 s waves -> (B, 1001, 64) dB log-mel through K1 on
    `waves`' device (no trim)."""
    return cuda_mel.log_mel(waves, _clap_mel_params(), trim=False)


class ClapFeatureExtractor:
    """The host extractor (float64 numpy). The device path for short clips,
    `device_log_mel_db`, belongs to the wrapper (`model.py:ClapWrapper`)."""

    def __init__(self, rng: np.random.Generator | None = None, replicate_hf_longer_quirk: bool = False):
        self.fb = mel_filterbank(N_FFT // 2 + 1, N_MELS, SAMPLE_RATE, F_MIN, F_MAX)
        self.rng = rng or np.random.default_rng(0)
        self.replicate_hf_longer_quirk = replicate_hf_longer_quirk

    def _one(self, waveform: np.ndarray) -> tuple[np.ndarray, bool]:
        waveform = np.asarray(waveform, dtype=np.float64).reshape(-1)
        if len(waveform) > MAX_SAMPLES:
            mel = _log_mel_db(waveform, self.fb)
            chunk_frames = MAX_SAMPLES // HOP + 1
            total_frames = mel.shape[0]
            if chunk_frames == total_frames:
                return np.stack([mel] * 4), False
            # 3 random crops, one from each third, and the bilinear-shrunk full mel
            ranges = np.array_split(np.arange(0, total_frames - chunk_frames + 1), 3)
            idxs = [int(self.rng.choice(r)) if len(r) else 0 for r in ranges]
            crops = [mel[i : i + chunk_frames] for i in idxs]
            shrink = _bilinear_resize(mel, chunk_frames, N_MELS)
            return np.stack([shrink, *crops]), True
        mel = _log_mel_db(self._pad_short(waveform), self.fb)
        return np.stack([mel] * 4), False

    def _pad_short(self, waveform: np.ndarray) -> np.ndarray:
        """repeatpad, then zero-pad to 10 s: the one home of this padding for
        the host and the device paths."""
        waveform = np.asarray(waveform, dtype=np.float64).reshape(-1)
        if len(waveform) == 0:  # a zero-length input is silence
            return np.zeros(MAX_SAMPLES)
        if len(waveform) < MAX_SAMPLES:
            n_repeat = int(MAX_SAMPLES / len(waveform))
            waveform = np.tile(waveform, max(n_repeat, 1))
            waveform = np.pad(waveform, (0, MAX_SAMPLES - len(waveform)))
        return waveform

    def __call__(self, audios: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
        """-> (input_features (B, 4, 1001, 64) f32, is_longer (B,) bool)."""
        mels, longer = zip(*(self._one(a) for a in audios))
        longer = list(longer)
        if self.replicate_hf_longer_quirk and not any(longer):
            longer[int(self.rng.integers(0, len(longer)))] = True
        return np.stack(mels).astype(np.float32), np.asarray(longer, dtype=bool)
