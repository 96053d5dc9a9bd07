"""K1: fused log-mel kernel (`csrc/log_mel.cu`) and its plain version.

Replaces `adt_str_tpu/ops/pallas_mel.py:pallas_log_mel`. Both versions here
compute what that kernel computes: bf16-rounded frames times the
Hann-windowed cos/-sin DFT bases (bf16, built exactly as the Pallas
`_constants` builds them) with fp32 accumulation, the power, the fp32 mel
projection, then the "norm" or "db" tail, with or without the trim.

`log_mel` is the wrapper the model calls: it launches the CUDA kernel for a
CUDA tensor and runs `log_mel_plain` for a CPU tensor, and nothing else (no
fallback from one to the other). `log_mel.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from adt_str_tpu_torch.ops import _build
from adt_str_tpu_torch.ops.mel import MelFrontendParams, frame_signal, hann_window_periodic, mel_filterbank

# Frequency tile of the CUDA kernel (`FT` in csrc/log_mel.cu): the bases are
# zero-padded to a multiple of it.
FREQ_TILE = 64
_LN10 = np.float32(np.log(10.0))


@functools.lru_cache(maxsize=4)
def _constants(params: MelFrontendParams) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(C, S, M) on the CPU: the windowed cos/-sin DFT bases (n_fft, k_pad)
    bf16 and the mel filterbank (k_pad, n_mels) fp32, zero-padded on the
    frequency axis. float64 cos/sin times the float64 window, then float32,
    then bf16 with round-to-nearest-even: the Pallas kernel's exact values."""
    n_fft, k = params.n_fft, params.n_freqs
    k_pad = -(-k // FREQ_TILE) * FREQ_TILE
    window = hann_window_periodic(n_fft).astype(np.float64)
    angle = 2.0 * np.pi * np.arange(k)[None, :] * np.arange(n_fft)[:, None] / n_fft
    C = np.zeros((n_fft, k_pad), np.float32)
    S = np.zeros((n_fft, k_pad), np.float32)
    C[:, :k] = (np.cos(angle) * window[:, None]).astype(np.float32)
    S[:, :k] = (-np.sin(angle) * window[:, None]).astype(np.float32)
    M = np.zeros((k_pad, params.n_mels), np.float32)
    M[:k] = mel_filterbank(k, params.n_mels, params.sample_rate, params.f_min, params.f_max)
    bf16 = torch.bfloat16
    return torch.from_numpy(C).to(bf16), torch.from_numpy(S).to(bf16), torch.from_numpy(M)


@functools.lru_cache(maxsize=8)
def _device_constants(params: MelFrontendParams, device: torch.device):
    return tuple(x.to(device) for x in _constants(params))


def _frame_range(params: MelFrontendParams, n_samples: int, trim: bool) -> tuple[int, int]:
    """(first frame, number of frames) of the output."""
    if trim:
        return params.window_pad_idxs, params.out_frames(n_samples)
    return 0, params.n_frames(n_samples)


def _tail(mel: torch.Tensor, params: MelFrontendParams) -> torch.Tensor:
    """The Pallas kernel's log tail (its "db" form divides by ln 10)."""
    if params.log_mode == "db":
        return 10.0 * torch.log(torch.clamp(mel, min=params.log_floor)) / _LN10
    logmel = torch.clamp(torch.log(mel + params.log_floor), params.clamp_lo, params.clamp_hi)
    return (logmel - params.clamp_lo) / (params.clamp_hi - params.clamp_lo)


def log_mel_plain(wave: torch.Tensor, params: MelFrontendParams, trim: bool = True) -> torch.Tensor:
    """Plain PyTorch K1 on `wave`'s device. The bf16 operands are multiplied
    as fp32 (`torch.matmul` of two bf16 CPU tensors would round its output
    to bf16), which reproduces fp32 accumulation of the bf16 products."""
    wave = wave.to(torch.float32)
    B, T = wave.shape
    C, S, M = _device_constants(params, wave.device)
    start, n_out = _frame_range(params, T, trim)
    frames = frame_signal(wave, params.n_fft, params.hop_length)[:, start : start + n_out]
    frames = frames.reshape(B * n_out, params.n_fft).to(torch.bfloat16).float()
    a = frames @ C.float()
    b = frames @ S.float()
    mel = (a * a + b * b) @ M
    return _tail(mel, params).reshape(B, n_out, params.n_mels)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("log_mel")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.launch_log_mel.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, f, f, f, i, p]
    lib.launch_log_mel.restype = ctypes.c_int
    lib.log_mel_freq_tile.restype = ctypes.c_int
    if lib.log_mel_freq_tile() != FREQ_TILE:
        raise RuntimeError("csrc/log_mel.cu FT differs from cuda_mel.FREQ_TILE")
    return lib


def log_mel(wave: torch.Tensor, params: MelFrontendParams, trim: bool = True) -> torch.Tensor:
    """(B, T) wave -> (B, frames, n_mels) fp32 through K1: the CUDA kernel
    for a CUDA tensor, `log_mel_plain` for a CPU tensor."""
    if wave.dim() != 2:
        raise ValueError(f"wave must be (B, T), got {tuple(wave.shape)}")
    if wave.device.type == "cpu":
        return log_mel_plain(wave, params, trim)
    if wave.device.type != "cuda":
        raise ValueError(f"log_mel runs on cpu or cuda tensors, not {wave.device}")
    B, T = wave.shape
    n_fft, hop = params.n_fft, params.hop_length
    if hop % 8 or n_fft % 64 or params.n_mels % 8 or params.n_mels > 128 or T <= n_fft // 2:
        raise ValueError(
            "the log-mel kernel needs hop % 8 == 0, n_fft % 64 == 0, n_mels % 8 == 0, "
            f"n_mels <= 128 and T > n_fft/2; got hop={hop} n_fft={n_fft} "
            f"n_mels={params.n_mels} T={T}"
        )
    lib = _lib()
    start, n_out = _frame_range(params, T, trim)
    if n_out <= 0:
        raise ValueError(f"a wave of {T} samples leaves no frame after the trim")
    wave = wave.to(torch.float32).contiguous()
    C, S, M = _device_constants(params, wave.device)
    out = torch.empty((B, n_out, params.n_mels), dtype=torch.float32, device=wave.device)
    with torch.cuda.device(wave.device):
        err = lib.launch_log_mel(
            wave.data_ptr(), C.data_ptr(), S.data_ptr(), M.data_ptr(), out.data_ptr(),
            B, T, n_fft, hop, C.shape[1], params.n_mels, start, n_out,
            params.log_floor, params.clamp_lo, params.clamp_hi, int(params.log_mode == "db"),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "log_mel")
    log_mel.launches += 1
    return out


log_mel.launches = 0
