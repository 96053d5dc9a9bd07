"""The yardstick: the card's peaks, each kernel's operations and bytes as
its inputs need them, the model's FLOPs, and the grouping of device
kernels by name.

A frozen copy of `chip_smoke.py`'s `bound`, `product_cost`, `PEAK_*`, the
per-kernel counts of its `phase_*` functions and `_group`, so that a change
to the program cannot move the measure it is judged by. Every count takes
each input byte read once and each output byte written once, and the work
these inputs need (the keys a query reads, the notes that sound), so no
share of a bound can pass 100% unless the time leaves out part of the work.

Peaks: NVIDIA's H100 SXM data sheet, dense, at its 700 W limit.
"""

from __future__ import annotations

import numpy as np

PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
TF32_PRODUCTS = 3  # an fp32-accurate product: three TF32 products on the tensor cores


def bound_s(flops_by_peak: list[tuple[float, float]], n_bytes: float) -> float:
    """The least time in seconds: the tensor-core and CUDA-core pipes and
    the memory run at once, so the slowest of the three binds."""
    ops_s = max((f / peak for f, peak in flops_by_peak), default=0.0)
    return max(ops_s, n_bytes / PEAK_BYTES)


def product_cost(flops: float, dtype_bytes: int) -> tuple[float, float]:
    """(operations, peak) of matrix products whose operands are 2-byte
    (bf16, fp16: the tensor cores at bf16's rate) or 4-byte (fp32: three
    TF32 products)."""
    if dtype_bytes == 4:
        return TF32_PRODUCTS * flops, PEAK_TF32
    return flops, PEAK_BF16


# ------------------------------------------------------------ per kernel


def used_bins(n_fft: int, n_mels: int, sample_rate: int, f_min: float = 20.0) -> int:
    """Bins 0..k-1 hold every mel filterbank weight above 1e-10 of the
    largest: the bins whose power the mel bands need."""
    from benchmark.reference.mel import mel_filterbank

    fb = mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate, f_min)
    used = np.flatnonzero((fb > 1e-10 * fb.max()).any(axis=1))
    return int(used[-1]) + 1 if used.size else 1


def log_mel(batch: int, samples: int, frames: int, n_fft: int, n_mels: int, bins: int) -> float:
    """K1 (`csrc/log_mel.cu`): the windowed DFT of the bins used as a bf16
    product (real and imaginary parts), the mel bands in fp32; the wave read
    once, the DFT table and the bands read once, the log-mel written once."""
    rows = batch * frames
    return bound_s([(4.0 * rows * n_fft * bins, PEAK_BF16), (2.0 * rows * bins * n_mels, PEAK_FP32)],
                   batch * samples * 4 + 2 * n_fft * bins * 2 + bins * n_mels * 4 + rows * n_mels * 4)


def gather_blend(requests: int, distinct_rows: int, row_len: int, elem_bytes: int = 2) -> float:
    """K2 (`csrc/gather_blend.cu`): each distinct bank row of the draws read
    once, one blend written per request, ids and weights read."""
    return bound_s([(3.0 * requests * row_len, PEAK_FP32)],
                   (distinct_rows + requests) * row_len * elem_bytes + requests * 12)


def place_notes(macs: float, row_samples: float, batch: int, chunk: int, note_slots: int,
                elem_bytes: int = 2) -> float:
    """K3 (`csrc/place_notes.cu`): one multiply-add a sample of each sounding
    note inside the chunk; each blend row read once up to the longest
    extent of its sounding notes, the chunk written once, the note metadata
    read."""
    return bound_s([(2.0 * macs, PEAK_FP32)], row_samples * elem_bytes + batch * chunk * 4 + note_slots * 12)


def place_notes_work(slot: np.ndarray, onset: np.ndarray, sounding: np.ndarray, row_len: int, chunk: int,
                     n_slots: int) -> tuple[float, float]:
    """(multiply-adds, blend row samples read) of K3 for (B, N) slots,
    onsets (samples) and the notes that sound."""
    extent = np.minimum(chunk - onset.astype(np.int64), row_len) * sounding
    rows = np.zeros((slot.shape[0], n_slots), np.int64)
    for b in range(slot.shape[0]):
        np.maximum.at(rows[b], slot[b].astype(np.int64), extent[b])
    return float(extent.sum()), float(rows.sum())


def attention_fwd(bh: int, tq: int, tk: int, head_dim: int, elem_bytes: int = 2, mask_rows: int = 0) -> float:
    """K5f (`csrc/attention.cu`): the two products, then scale, mask, max,
    exp and sum in fp32; q, k, v read once, out written once, the lse, and
    an fp32 (tq, tk) mask per item when there is one."""
    return bound_s([product_cost(4.0 * bh * tq * tk * head_dim, elem_bytes), (5.0 * bh * tq * tk, PEAK_FP32)],
                   2 * bh * (tq + tk) * head_dim * elem_bytes + mask_rows * tq * tk * 4 + bh * tq * 4)


def layer_norm(rows: int, d: int, elem_bytes: int = 2, fused_add: bool = False) -> float:
    """LayerNorm (`csrc/layer_norm.cu`), with the residual add fused or not:
    the rows (and the residual) read once, the output written once, w and b."""
    reads = 2 if fused_add else 1
    return bound_s([((8.0 + fused_add) * rows * d, PEAK_FP32)],
                   rows * d * elem_bytes * (reads + 1) + 2 * d * 4)


def linear(m: int, n: int, k: int, elem_bytes: int = 2) -> float:
    """The inference product (`csrc/linear.cu`), x W^T + b: x, W, b read
    once, the output written once."""
    return bound_s([product_cost(2.0 * m * n * k, elem_bytes)], (m * k + n * k + n + m * n) * elem_bytes)


def attention_rows(bh: int, tq: int, tk: int, head_dim: int, elem_bytes: int = 2) -> float:
    """Inference attention (`csrc/attention_rows.cu`) of tq query rows over
    the tk keys they read: q, k, v read once, out written once."""
    return bound_s([(4.0 * bh * tq * tk * head_dim, PEAK_FP32)],
                   elem_bytes * bh * (2 * tq + 2 * tk) * head_dim + tk * 4)


# ------------------------------------------------------------ model FLOPs


def encoder_flops(batch: int, frames: int, d: int, d_ff: int, layers: int, n_mels: int) -> float:
    """Matrix-product FLOPs of one encoder forward pass: the mel projection,
    the dense layer, and each layer's in-projection, attention (both
    products over every frame), out-projection and FFN."""
    rows = batch * frames
    per_layer = 2.0 * rows * d * 3 * d + 4.0 * batch * frames * frames * d + 2.0 * rows * d * d \
        + 4.0 * rows * d * d_ff
    return 2.0 * rows * n_mels * d + 2.0 * rows * d * d + layers * per_layer


def decoder_flops(batch: int, tokens: int, frames: int, d: int, d_ff: int, layers: int, vocab: int) -> float:
    """Matrix-product FLOPs of one teacher-forced decoder pass over `tokens`
    positions: causal self-attention counts the keys at or before each query
    (t (t + 1) / 2), cross-attention every frame."""
    rows = batch * tokens
    causal_pairs = batch * tokens * (tokens + 1) / 2
    per_layer = (2.0 * rows * d * 3 * d + 4.0 * causal_pairs * d + 2.0 * rows * d * d  # self
                 + 2.0 * rows * d * d + 2.0 * batch * frames * d * 2 * d + 4.0 * rows * frames * d
                 + 2.0 * rows * d * d  # cross
                 + 4.0 * rows * d * d_ff)
    return layers * per_layer + 2.0 * rows * d * vocab


def train_step_flops(batch: int, frames: int, tokens: int, d: int, d_ff: int, enc_layers: int, dec_layers: int,
                     n_mels: int, vocab: int) -> float:
    """Forward and backward of one training step: the backward's two
    products for each of the forward's (no recompute), the frontend and the
    synthesis not counted."""
    fwd = encoder_flops(batch, frames, d, d_ff, enc_layers, n_mels) \
        + decoder_flops(batch, tokens, frames, d, d_ff, dec_layers, vocab)
    return 3.0 * fwd


def cross_kv_flops(items: int, frames: int, d: int, layers: int) -> float:
    """The decoder's cross K and V, projected once an item from its memory."""
    return layers * 2.0 * items * frames * d * 2 * d


def decode_step_flops(rows: int, keys: int, frames: int, d: int, d_ff: int, layers: int, vocab: int) -> float:
    """One incremental decode step of `rows` query rows (items times beams)
    attending `keys` cached positions and every frame."""
    return layers * (2.0 * rows * d * 3 * d + 2.0 * rows * d * d + 4.0 * rows * keys * d + 2.0 * rows * d * d
                     + 4.0 * rows * frames * d + 2.0 * rows * d * d + 4.0 * rows * d * d_ff) + 2.0 * rows * d * vocab


def decode_flops(items: int, rows: int, steps: int, frames: int, d: int, d_ff: int, layers: int,
                 vocab: int) -> float:
    """A whole incremental decode: the cross K and V, then `steps` steps,
    step s attending s + 1 keys."""
    return cross_kv_flops(items, frames, d, layers) + sum(
        decode_step_flops(rows, s + 1, frames, d, d_ff, layers, vocab) for s in range(steps))


# ------------------------------------------------------------ device groups


def group(name: str) -> str:
    """The part of a step a device kernel belongs to (`chip_smoke._group`,
    frozen). The port's own kernels come first; the int64 elementwise
    kernels are the dropout hash's."""
    for key, grp in (("attention_fwd_kernel", "K5f attention fwd"), ("attention_bwd", "K5b attention bwd"),
                     ("attention_delta", "K5b attention bwd"), ("ffn_dropout_kernel", "K4 fused FFN"),
                     ("attention_tf32_fwd", "K5f attention fwd"), ("attention_tf32_delta", "K5b attention bwd"),
                     ("attention_tf32_dkdv", "K5b attention bwd"), ("attention_tf32_dq", "K5b attention bwd"),
                     ("wide_fwd_kernel", "K5f attention fwd"), ("wide_bwd_kernel", "K5b attention bwd"),
                     ("wide_delta_kernel", "K5b attention bwd"), ("ffn_tf32_gemm", "K4 fused FFN"),
                     ("log_mel_", "K1 log-mel"), ("gather_blend_kernel", "K2 gather + blend"),
                     ("place_notes_kernel", "K3 note placement"), ("layer_norm_", "layer_norm"),
                     ("linear_bf16_kernel", "linear"), ("linear_f32_kernel", "linear"),
                     ("attention_rows_", "attention_rows")):
        if key in name:
            return grp
    low = name.lower()
    if any(k in low for k in ("gemm", "xmma", "cutlass", "sm90_", "cublas", "nvjet")):
        return "GEMM (cuBLAS)"
    if "<long" in low or "arange" in low:
        return "int64 elementwise (dropout hash)"
    if "softmax" in low:
        return "softmax"
    if "fft" in low:
        return "FFT"
    if "reduce" in low:
        return "reductions (LayerNorm, sums, norms)"
    if "indexing_backward" in low or "embedding" in low:
        return "embedding"
    if any(k in low for k in ("copy", "memcpy", "memset", "cast")):
        return "copies, casts"
    return "other elementwise"


HASH_GROUP = "int64 elementwise (dropout hash)"
