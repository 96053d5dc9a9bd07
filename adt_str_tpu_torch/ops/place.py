"""The synthesiser's two kernels in plain PyTorch: K2 gather + mixup blend
and K3 note placement.

Plain versions of `adt_str_tpu/synth/pallas_place.py:gather_blend` and
`place_notes`. They define what `csrc/gather_blend.cu` and
`csrc/place_notes.cu` compute: the same f32 operations in the same order,
each rounded on its own (no fused multiply-add), so the kernels are
bit-equal to them on the card. The wrappers in `ops/cuda_place.py` run
these for CPU tensors.
"""

from __future__ import annotations

import torch


def gather_blend_plain(table: torch.Tensor, idx_main: torch.Tensor, idx_sub: torch.Tensor,
                       lam: torch.Tensor) -> torch.Tensor:
    """(n_rows, L) table, (N,) row ids, (N,) mixup weights -> (N, L)
    `(1 - lam) * table[main] + lam * table[sub]`, computed in f32 and stored
    in the table's dtype (as the TPU kernel blends; the JAX package's XLA
    path blends in the table's dtype instead). Row ids outside [0, n_rows)
    are clamped into it, as JAX's gathers clamp."""
    last = table.shape[0] - 1
    m = table.index_select(0, idx_main.long().clamp(0, last)).float()
    s = table.index_select(0, idx_sub.long().clamp(0, last)).float()
    lam = lam.float()[:, None]
    return ((1.0 - lam) * m + lam * s).to(table.dtype)


def place_notes_plain(blend: torch.Tensor, slot: torch.Tensor, onset: torch.Tensor, gain: torch.Tensor,
                      chunk_samples: int) -> torch.Tensor:
    """(B, S, L) blend rows, (B, N) slots in [0, S), onsets in
    [0, chunk_samples) (either clamped into its range) and f32 gains ->
    (B, chunk_samples) f32:
    `out[b, t] = sum_n gain[b, n] * blend[b, slot[b, n], t - onset[b, n]]`
    over 0 <= t - onset < L, the notes added one after another in note
    order, each product rounded to f32 before its sum; what runs past the
    chunk is clipped."""
    B, S, L = blend.shape
    buf = torch.zeros(B, chunk_samples + L, dtype=torch.float32, device=blend.device)
    rows = torch.arange(B, device=blend.device)
    pos = torch.arange(L, device=blend.device)
    slot, onset, gain = slot.long().clamp(0, S - 1), onset.long().clamp(0, chunk_samples - 1), gain.float()
    for n in range(slot.shape[1]):
        contrib = gain[:, n : n + 1] * blend[rows, slot[:, n]].float()
        buf.scatter_add_(1, onset[:, n : n + 1] + pos, contrib)
    return buf[:, :chunk_samples].contiguous()
