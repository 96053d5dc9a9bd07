"""Post-norm transformer encoder/decoder layers.

Port of `adt_str_tpu/models/transformer.py`. Parameters live in
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

Training (`train=True`) adds the JAX package's inverted dropout: a counter
hash of the flat element index and two seed words (`ops/dropout_hash.py`), whose
backward regenerates the mask. torch cannot reproduce `jax.random.split`,
so each dropout site takes its key as data: a pair of uint32 words (the
`key_data` of the JAX key at that site; `models/adt.py:dropout_sites` names
the sites in the JAX split order). Per layer the keys are, as in
`encoder_layer_forward` / `decoder_layer_forward`:

- encoder: [attention residual, FFN hidden, FFN output, attention probs];
- decoder: [self residual, cross residual, FFN hidden, FFN output,
  self-attention probs, cross-attention probs].

Attention goes to the K5 kernels (`ops/cuda_attention.py`) under the rule of
the JAX package's `_fused_attention_ok`: the flag is on, the head dim is a
multiple of 128, and attention-probability dropout is inactive. The FFN goes
to K4 (`ops/cuda_ffn.py`) under `_fused_ffn_ok`: the flag is on, training
with dropout and a key, d_model a multiple of 128. The LayerNorms and the
attention outside K5 go through `ops/layer_norm.py` and
`ops/attention_rows.py`: on the card's inference path their kernels sum in
an order fixed by a row's shape, so a row's bits do not follow the rows
beside it; training runs their plain versions under autograd. The other
products run cuBLAS, except where a caller asks for `fixed_order`: the
decode step (`models/decode.py`), whose products at 1-320 rows gave a row
other bits beside other rows, goes to `ops/linear.py`'s kernel. The
encoder's products and the memory's K/V projections (246 rows a chunk)
keep cuBLAS: the batch probe (`chip_smoke.py:batch_probe`) finds them
row-independent at every serving bucket.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from adt_str_tpu_torch.ops import attention_rows, cuda_attention, cuda_ffn
from adt_str_tpu_torch.ops import layer_norm as ln_ops
from adt_str_tpu_torch.ops import linear as linear_ops
from adt_str_tpu_torch.ops.dropout_hash import hash_mask, seed_from_key

Key = Optional[tuple[int, int]]  # the two uint32 words of a site's key

NEG_MASK = -1e4


def linear(mod: nn.Linear, x: torch.Tensor, fixed_order: bool = False) -> torch.Tensor:
    """`x @ w^T + b` in `x`'s dtype; `fixed_order`: through `ops/linear.py`'s
    wrapper (its kernel on the card's inference path), else cuBLAS."""
    product = linear_ops.linear if fixed_order else linear_ops.linear_plain
    return product(x, mod.weight, mod.bias)


def layer_norm(mod: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm with fp32 statistics, cast back to `x`'s dtype (`ops/layer_norm.py`)."""
    return ln_ops.layer_norm(x, mod.weight, mod.bias, mod.eps)


def _scale(x: torch.Tensor, keep: float) -> torch.Tensor:
    """`where(mask, x * (1 / keep), 0)`'s product with JAX's rounding: the
    weakly typed 1/keep becomes a constant of x's dtype first."""
    return x * torch.tensor(1.0 / keep, dtype=x.dtype, device=x.device)


class _DropoutRegen(torch.autograd.Function):
    """Inverted dropout whose only residual is the seed: the backward
    regenerates the mask (JAX `_dropout_regen`)."""

    @staticmethod
    def forward(ctx, x, keep: float, seed: tuple[int, int]):
        ctx.keep, ctx.seed = keep, seed
        m = hash_mask(x.shape, seed, keep, x.device)
        return torch.where(m, _scale(x, keep), 0.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        m = hash_mask(g.shape, ctx.seed, ctx.keep, g.device)
        return torch.where(m, _scale(g, ctx.keep), 0.0).to(g.dtype), None, None


def dropout(x: torch.Tensor, rate: float, key: Key, train: bool) -> torch.Tensor:
    """Inverted dropout with the counter-hash mask of `key`'s two words."""
    if not train or rate == 0.0 or key is None:
        return x
    return _DropoutRegen.apply(x, 1.0 - rate, seed_from_key(key))


def split_heads(x: torch.Tensor, nhead: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, nhead, d // nhead).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def attention_core(
    q, k, v, mask: Optional[torch.Tensor], dropout_rate: float = 0.0, dropout_key: Key = None,
    train: bool = False,
) -> torch.Tensor:
    """(B,H,Tq,hd) x (B,H,Tk,hd) attention outside K5 (`ops/attention_rows.py`);
    `mask` is an additive float mask broadcastable to (B,H,Tq,Tk). In
    training the probabilities take dropout, as `nn.MultiheadAttention` does."""
    if not train or dropout_rate == 0.0 or dropout_key is None:
        return attention_rows.attention(q, k, v, mask)
    probs = attention_rows.attention_probs(q, k, mask)
    return torch.matmul(dropout(probs, dropout_rate, dropout_key, train), v)


def _fused_attention_ok(q: torch.Tensor, train: bool, dropout_rate: float) -> bool:
    """K5 applies when attention-probability dropout is inactive (the kernel
    has none) and the head dim is a multiple of 128."""
    return (not train or dropout_rate == 0.0) and q.shape[-1] % 128 == 0


def _flash_attention(q, k, v, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """K5 (forward and backward) with the mask broadcast to the (B, Tq, Tk)
    layout it takes. The keys JAX pads on are counted, not stored
    (`cuda_attention.virtual_keys`)."""
    B, _, Tq, _ = q.shape
    Tk = k.shape[2]
    m3 = None
    if mask is not None:
        m3 = torch.broadcast_to(mask.float(), (B, 1, Tq, Tk))[:, 0].contiguous()
    return cuda_attention.FusedAttention.apply(q, k, v, m3, cuda_attention.virtual_keys(Tq, Tk))


class MultiheadAttention(nn.Module):
    """Packed q|k|v input projection (`in_proj_weight` rows 0:d, d:2d, 2d:3d)
    and `out_proj`, as in `nn.MultiheadAttention`."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def project(self, x: torch.Tensor, part: slice, fixed_order: bool = False) -> torch.Tensor:
        """`x @ W[part]^T + b[part]` split into heads (part: q, k or v rows);
        `fixed_order` as in `linear`."""
        product = linear_ops.linear if fixed_order else linear_ops.linear_plain
        return split_heads(product(x, self.in_proj_weight[part], self.in_proj_bias[part]), self.nhead)

    def forward(self, query, key_value, mask=None, use_flash: bool = False, dropout_rate: float = 0.0,
                dropout_key: Key = None, train: bool = False) -> torch.Tensor:
        d = query.shape[-1]
        q = self.project(query, slice(0, d))
        k = self.project(key_value, slice(d, 2 * d))
        v = self.project(key_value, slice(2 * d, 3 * d))
        if use_flash and _fused_attention_ok(q, train, dropout_rate):
            out = _flash_attention(q, k, v, mask)
        else:
            out = attention_core(q, k, v, mask, dropout_rate, dropout_key, train)
        return linear(self.out_proj, merge_heads(out))


def ffn(layer: nn.Module, x: torch.Tensor, dropout_rate: float = 0.0, key: Key = None,
        train: bool = False, fixed_order: bool = False) -> torch.Tensor:
    """linear2(dropout(gelu(linear1(x)))) with the exact erf GELU;
    `fixed_order` as in `linear`."""
    h = torch.nn.functional.gelu(linear(layer.linear1, x, fixed_order))
    return linear(layer.linear2, dropout(h, dropout_rate, key, train), fixed_order)


def _fused_ffn_ok(x: torch.Tensor, train: bool, rate: float, key: Key) -> bool:
    """K4 covers the training configuration: dropout active with a key and
    d_model a multiple of 128."""
    return train and rate > 0.0 and key is not None and x.shape[-1] % 128 == 0


def ffn_dropout_block(layer: nn.Module, x: torch.Tensor, rate: float, key_h: Key, key_o: Key) -> torch.Tensor:
    """`dropout(linear2(dropout(gelu(linear1(x)))))` through K4
    (`ops/cuda_ffn.py`), with the same mask stream as `dropout` draws for
    the same keys."""
    b, t, d = x.shape
    seeds = seed_from_key(key_h) + seed_from_key(key_o)
    out = cuda_ffn.FusedFfnDropout.apply(
        x.reshape(b * t, d), layer.linear1.weight, layer.linear1.bias, layer.linear2.weight,
        layer.linear2.bias, seeds, 1.0 - rate, 1.0 - rate,
    )
    return out.reshape(b, t, d)


def _ffn_residual(layer, x, rate, key_h: Key, key_o: Key, train: bool, use_pallas_ffn: bool):
    """The FFN branch with its output dropout, through K4 when it applies."""
    if use_pallas_ffn and _fused_ffn_ok(x, train, rate, key_h):
        return ffn_dropout_block(layer, x, rate, key_h, key_o)
    return dropout(ffn(layer, x, rate, key_h, train), rate, key_o, train)


def _keys(keys: Optional[Sequence[Key]], n: int) -> Sequence[Key]:
    if keys is None:
        return (None,) * n
    if len(keys) != n:
        raise ValueError(f"a layer takes {n} dropout keys, got {len(keys)}")
    return keys


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, d_ff: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)

    def forward(self, x, mask=None, use_flash: bool = False, use_pallas_ffn: bool = False,
                dropout_rate: float = 0.0, keys: Optional[Sequence[Key]] = None, train: bool = False):
        """`keys`: the layer's 4 site keys (None: no dropout)."""
        k = _keys(keys, 4)
        attn = self.self_attn(x, x, mask, use_flash, dropout_rate, k[3], train)
        x = layer_norm(self.norm1, x + dropout(attn, dropout_rate, k[0], train))
        ff = _ffn_residual(self, x, dropout_rate, k[1], k[2], train, use_pallas_ffn)
        return layer_norm(self.norm2, x + ff)


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

    def forward(self, x, memory, self_mask=None, cross_mask=None, use_flash: bool = False,
                use_pallas_ffn: bool = False, dropout_rate: float = 0.0,
                keys: Optional[Sequence[Key]] = None, train: bool = False):
        """`keys`: the layer's 6 site keys (None: no dropout)."""
        k = _keys(keys, 6)
        attn = self.self_attn(x, x, self_mask, use_flash, dropout_rate, k[4], train)
        x = layer_norm(self.norm1, x + dropout(attn, dropout_rate, k[0], train))
        cross = self.multihead_attn(x, memory, cross_mask, use_flash, dropout_rate, k[5], train)
        x = layer_norm(self.norm2, x + dropout(cross, dropout_rate, k[1], train))
        ff = _ffn_residual(self, x, dropout_rate, k[2], k[3], train, use_pallas_ffn)
        return layer_norm(self.norm3, x + ff)


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
