"""Host audio I/O: decoding, resampling, peak normalisation, WAV writing.

Port of `adt_str_tpu/utils/audio_io.py` (its own copy): WAV via
scipy.io.wavfile, other containers through an ffmpeg subprocess when one is
installed, polyphase resampling via `scipy.signal.resample_poly`.
"""

from __future__ import annotations

import math
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """-> (float32 mono-or-(C,T) waveform in [-1, 1], sample_rate)."""
    sr, data = wavfile.read(str(path))
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.T  # (C, T)
    return data, sr


def write_wav(path: str | Path, wave: np.ndarray, sample_rate: int) -> None:
    """float32 WAV; a (C, T) wave is written as C channels."""
    wave = np.asarray(wave, dtype=np.float32)
    if wave.ndim == 2:
        wave = wave.T
    wavfile.write(str(path), sample_rate, wave)


def _load_via_ffmpeg(path: str | Path) -> tuple[np.ndarray, int]:
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            f"Cannot decode {path}: not a WAV file and ffmpeg is unavailable"
        )
    with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
        cmd = ["ffmpeg", "-y", "-i", str(path), "-f", "wav", tmp.name]
        subprocess.run(cmd, check=True, capture_output=True)
        return read_wav(tmp.name)


def resample(wave: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampler (torchaudio `T.Resample` equivalent)."""
    if orig_sr == target_sr:
        return np.asarray(wave, dtype=np.float32)
    g = math.gcd(int(orig_sr), int(target_sr))
    out = resample_poly(
        np.asarray(wave, dtype=np.float64), target_sr // g, orig_sr // g, axis=-1
    )
    return out.astype(np.float32)


def normalize(wave: np.ndarray) -> np.ndarray:
    """Peak normalise (an epsilon guards the all-zero wave)."""
    peak = np.abs(wave).max()
    return wave / max(peak, 1e-8)


def load_and_resample(path: str | Path, target_sr: int | None) -> np.ndarray:
    """Load any audio file -> mono float32, resampled to `target_sr`."""
    path = Path(path)
    if path.suffix.lower() == ".wav":
        wave, sr = read_wav(path)
    else:
        wave, sr = _load_via_ffmpeg(path)
    if wave.ndim == 2:
        wave = wave.mean(axis=0)
    if target_sr is None or sr == target_sr:
        return wave.astype(np.float32)
    return resample(wave, sr, target_sr)
