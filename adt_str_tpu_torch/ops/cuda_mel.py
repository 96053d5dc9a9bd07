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

# The bases are zero-padded to a multiple of FREQ_PAD bins (the kernel's
# TMA rows must be 16-byte multiples). The CUDA kernel computes tiles of
# FREQ_TILE bins for TILE_FRAMES frames a block (`FT`, `TILE_F` in
# csrc/log_mel.cu).
FREQ_PAD = 64
FREQ_TILE = 128
TILE_FRAMES = 128
_LN10 = np.float32(np.log(10.0))


@functools.lru_cache(maxsize=4)
def _constants(params: MelFrontendParams) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(C, S, M) on the CPU: the windowed cos/-sin DFT bases (n_fft, k_pad)
    bf16 and the mel filterbank (k_pad, n_mels) fp32, zero-padded on the
    frequency axis. float64 cos/sin times the float64 window, then float32,
    then bf16 with round-to-nearest-even: the Pallas kernel's exact values."""
    n_fft, k = params.n_fft, params.n_freqs
    k_pad = -(-k // FREQ_PAD) * FREQ_PAD
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


@functools.lru_cache(maxsize=4)
def mel_table(params: MelFrontendParams) -> torch.Tensor:
    """The kernel's sparse form of the mel filterbank: an (n_tiles * 128, 4)
    fp32 table whose row j holds (w0, w1, m0, 0), bin j's weights in bands
    m0 and m0 + 1 (m0 stored as int32 bits, 0 <= m0 <= n_mels - 2), the
    only bands where an HTK triangular filterbank can weigh it. Bins past
    the last weight above 1e-10 of the largest are dropped (their power adds
    exact zeros or, for the bin at f_max, a rounding residue: 6.5e-15 at the
    model's frontend, where it would cost a ninth tile of 128 bins for one
    bin); the table is padded to whole tiles with zero weights. Raises if a
    bin weighs bands other than two adjacent ones or m0 decreases: the
    kernel's in-order band sums need both."""
    n_mels = params.n_mels
    if n_mels < 2:
        raise ValueError(f"the log-mel kernel needs n_mels >= 2, got {n_mels}")
    M = mel_filterbank(params.n_freqs, n_mels, params.sample_rate, params.f_min, params.f_max)
    used = np.flatnonzero((M > 1e-10 * M.max()).any(axis=1))
    k_used = int(used[-1]) + 1 if used.size else 1
    n_tiles = -(-k_used // FREQ_TILE)
    w = np.zeros((n_tiles * FREQ_TILE, 2), np.float32)
    m0 = np.zeros(n_tiles * FREQ_TILE, np.int64)
    prev = 0
    for j in range(n_tiles * FREQ_TILE):
        nz = np.flatnonzero(M[j]) if j < k_used else np.zeros(0, np.int64)
        if nz.size > 2 or (nz.size == 2 and nz[1] != nz[0] + 1):
            raise ValueError(f"mel bin {j} weighs bands {nz.tolist()}: not two adjacent bands")
        first = prev if nz.size == 0 else min(int(nz[0]), n_mels - 2)
        if first < prev:
            raise ValueError(f"mel bin {j}'s first band {first} is below bin {j - 1}'s {prev}")
        m0[j] = prev = first
        for m in nz:
            w[j, m - first] = M[j, m]
    table = np.zeros((n_tiles * FREQ_TILE, 4), np.float32)
    table[:, :2] = w
    table[:, 2] = m0.astype(np.int32).view(np.float32)
    return torch.from_numpy(table)


def freq_split(blocks: int, n_tiles: int, sms: int) -> int:
    """Blocks that share one frame tile's frequency tiles: the largest power
    of two (at most n_tiles) that keeps the grid within one wave of `sms`
    SMs. B = 64 serving chunks (128 frame tiles) -> 1; B = 16 -> 4; B = 1 -> 8."""
    split = 1
    while 2 * split <= n_tiles and blocks * 2 * split <= sms:
        split *= 2
    return split


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


@functools.lru_cache(maxsize=8)
def _device_table(params: MelFrontendParams, device: torch.device) -> torch.Tensor:
    return mel_table(params).to(device)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("log_mel")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.launch_log_mel.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, f, f, f, i, p]
    lib.launch_log_mel.restype = ctypes.c_int
    lib.log_mel_freq_tile.restype = lib.log_mel_frame_tile.restype = ctypes.c_int
    if lib.log_mel_freq_tile() != FREQ_TILE or lib.log_mel_frame_tile() != TILE_FRAMES:
        raise RuntimeError("csrc/log_mel.cu tiles differ from cuda_mel's")
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
    if hop % 8 or n_fft % 64 or T <= n_fft // 2:
        raise ValueError(
            "the log-mel kernel needs hop % 8 == 0, n_fft % 64 == 0 and T > n_fft/2; "
            f"got hop={hop} n_fft={n_fft} T={T}"
        )
    lib = _lib()
    start, n_out = _frame_range(params, T, trim)
    if n_out <= 0:
        raise ValueError(f"a wave of {T} samples leaves no frame after the trim")
    wave = wave.to(torch.float32).contiguous()
    C, S, _ = _device_constants(params, wave.device)
    table = _device_table(params, wave.device)
    n_tiles = table.shape[0] // FREQ_TILE
    blocks = B * -(-n_out // TILE_FRAMES)
    split = freq_split(blocks, n_tiles, torch.cuda.get_device_properties(wave.device).multi_processor_count)
    out = torch.empty((B, n_out, params.n_mels), dtype=torch.float32, device=wave.device)
    parts = torch.empty((split, *out.shape), dtype=torch.float32, device=wave.device) if split > 1 else None
    with torch.cuda.device(wave.device):
        err = lib.launch_log_mel(
            wave.data_ptr(), C.data_ptr(), S.data_ptr(), table.data_ptr(), out.data_ptr(),
            None if parts is None else parts.data_ptr(), B, T, n_fft, hop, C.shape[1], n_tiles,
            params.n_mels, start, n_out, split,
            params.log_floor, params.clamp_lo, params.clamp_hi, int(params.log_mode == "db"),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "log_mel")
    log_mel.launches += 1
    return out


log_mel.launches = 0
