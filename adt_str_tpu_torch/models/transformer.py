"""Post-norm transformer encoder/decoder layers.

Port of `adt_str_tpu/models/transformer.py` (inference side: serving runs
with `train=False`, so there is no dropout here). Parameters live in
`nn.Module`s named as PyTorch's own `TransformerEncoderLayer` /
`TransformerDecoderLayer` name them (`self_attn.in_proj_weight`,
`multihead_attn`, `linear1`, `norm1`, ...), so a reference state dict loads
with `strict=True`. The forward functions follow the JAX package's rounding
points rather than `nn.MultiheadAttention`'s:

- linear: `x @ w + b` in the compute dtype (matmul rounded, then bias);
- LayerNorm statistics in fp32, the result cast back;
- attention scores in fp32 from the compute-dtype q, k; softmax in fp32;
  probabilities cast to the compute dtype before P.V;
- additive masks of 0 / `NEG_MASK` (-1e4), never -inf.

Self-attention goes to the K5 kernel (`ops/cuda_attention.py`) under the
same rule as the JAX package's `_fused_attention_ok`: the flag is on and the
head dim is a multiple of 128.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from adt_str_tpu_torch.ops import cuda_attention

NEG_MASK = -1e4


def linear(mod: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """`x @ w^T + b` in `x`'s dtype."""
    y = x @ mod.weight.to(x.dtype).T
    if mod.bias is not None:
        y = y + mod.bias.to(x.dtype)
    return y


def layer_norm(mod: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm with fp32 statistics, cast back to `x`'s dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + mod.eps)
    return (y * mod.weight.float() + mod.bias.float()).to(x.dtype)


def split_heads(x: torch.Tensor, nhead: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, nhead, d // nhead).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def attention_core(q, k, v, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B,H,Tq,hd) x (B,H,Tk,hd) attention without a kernel; `mask` is an
    additive float mask broadcastable to (B,H,Tq,Tk)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def _flash_attention(q, k, v, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """K5 with the mask broadcast to the (B, Tq, Tk) layout it takes."""
    B, _, Tq, _ = q.shape
    m3 = None
    if mask is not None:
        m3 = torch.broadcast_to(mask.float(), (B, 1, Tq, k.shape[2]))[:, 0].contiguous()
    out, _ = cuda_attention.fused_attention(q, k, v, m3)
    return out


class MultiheadAttention(nn.Module):
    """Packed q|k|v input projection (`in_proj_weight` rows 0:d, d:2d, 2d:3d)
    and `out_proj`, as in `nn.MultiheadAttention`."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def project(self, x: torch.Tensor, part: slice) -> torch.Tensor:
        """`x @ W[part]^T + b[part]` split into heads (part: q, k or v rows)."""
        w = self.in_proj_weight[part].to(x.dtype)
        return split_heads(x @ w.T + self.in_proj_bias[part].to(x.dtype), self.nhead)

    def forward(self, query, key_value, mask=None, use_flash: bool = False) -> torch.Tensor:
        d = query.shape[-1]
        q = self.project(query, slice(0, d))
        k = self.project(key_value, slice(d, 2 * d))
        v = self.project(key_value, slice(2 * d, 3 * d))
        if use_flash and q.shape[-1] % 128 == 0:
            out = _flash_attention(q, k, v, mask)
        else:
            out = attention_core(q, k, v, mask)
        return linear(self.out_proj, merge_heads(out))


def ffn(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """linear2(gelu(linear1(x))) with the exact erf GELU."""
    return linear(layer.linear2, torch.nn.functional.gelu(linear(layer.linear1, x)))


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, d_ff: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)

    def forward(self, x, mask=None, use_flash: bool = False):
        x = layer_norm(self.norm1, x + self.self_attn(x, x, mask, use_flash))
        return layer_norm(self.norm2, x + ffn(self, x))


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, d_ff: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.multihead_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)
        self.norm3 = nn.LayerNorm(d_model)

    def forward(self, x, memory, self_mask=None, cross_mask=None, use_flash: bool = False):
        x = layer_norm(self.norm1, x + self.self_attn(x, x, self_mask, use_flash))
        x = layer_norm(self.norm2, x + self.multihead_attn(x, memory, cross_mask, use_flash))
        return layer_norm(self.norm3, x + ffn(self, x))


def sinusoidal_positions(maxlen: int, d_model: int) -> np.ndarray:
    """Interleaved sin/cos table with den = exp(-2i ln(1e4)/d)."""
    den = np.exp(-np.arange(0, d_model, 2) * math.log(10000.0) / d_model)
    pos = np.arange(maxlen)[:, None]
    table = np.zeros((maxlen, d_model), dtype=np.float32)
    table[:, 0::2] = np.sin(pos * den)
    table[:, 1::2] = np.cos(pos * den)
    return table


def causal_mask_additive(seq_len: int, device=None) -> torch.Tensor:
    """(1, 1, T, T) additive causal mask: 0 on/below the diagonal, -1e4 above."""
    mask = torch.triu(torch.full((seq_len, seq_len), NEG_MASK, device=device), diagonal=1)
    return mask[None, None]


def padding_mask_additive(lengths: torch.Tensor, seq_len: int) -> torch.Tensor:
    """(B, 1, 1, T) additive key-padding mask: positions >= length masked."""
    pos = torch.arange(seq_len, device=lengths.device)
    pad = pos[None, :] >= lengths[:, None]
    return torch.where(pad, NEG_MASK, 0.0).float()[:, None, None, :]
