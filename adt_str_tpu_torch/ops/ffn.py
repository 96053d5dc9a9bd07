"""K4's plain versions: the fused FFN + dropout forward and its backward.

Port of `adt_str_tpu/ops/pallas_ffn.py`. `ffn_dropout_plain` computes what
the Pallas `_fwd_kernel` computes, at its rounding points:

    pre = bf16(x W1 + b1)                      fp32 accumulation, returned
    hd  = bf16(mask_h ? gelu(pre) / keep_h : 0)  gelu with the Abramowitz-
                                                 Stegun erf (`erf_as`)
    out = bf16(mask_o ? (hd W2 + b2) / keep_o : 0)

with the counter-hash masks of `dropout_hash.hash_mask` over the flat index
of the unpadded (N, d_ff) and (N, d) arrays, so they are bit-identical to
the XLA path's `dropout` for the same keys. ("bf16" is the compute dtype.)

Under tensor parallelism a rank holds d_ff columns of the whole width
`d_ff_total`, from `col0`: its hidden mask is the hash at the whole-width
index `r * d_ff_total + col0 + c` (`dropout_hash.hash_mask_slice`), and
with `b2` None (the partial mode) the forward returns the fp32 product
`hd W2_shard^T` alone: b2 and the output dropout come after the sum over
the ranks (`models/transformer.py:ffn_dropout_block`). `col0` 0, the
whole width and b2 given are the one-process call.

`ffn_dropout_bwd_plain` mirrors `_vjp_bwd`: it recomputes from the saved
`pre` with the exact erf, regenerates both masks, and forms the four
products with fp32 results. JAX leaves those products to XLA, so they are
library matmuls here too (on the card, bf16 cuBLAS products whose outputs
round to bf16 before the fp32 cast). The weights come in the kernel's layout
(`ops/cuda_ffn.py`), the module's own: W1 as `linear1.weight` (d_ff, d) and
W2 as `linear2.weight` (d, d_ff), both already in the compute dtype.
"""

from __future__ import annotations

import math

import torch

from adt_str_tpu_torch.ops.dropout_hash import hash_mask, hash_mask_slice

_SQRT_2 = math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def erf_as(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.26 rational erf (max abs err 1.5e-7), as `_erf`."""
    s = torch.sign(x)
    a = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return s * (1.0 - poly * torch.exp(-a * a))


def gelu_as(p: torch.Tensor) -> torch.Tensor:
    return p * 0.5 * (1.0 + erf_as(p / _SQRT_2))


def _dot32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of compute-dtype operands with fp32 accumulation and result."""
    return torch.matmul(a.float(), b.float())


def _dot_lib(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The backward's library product: fp32 operands on the CPU; bf16
    operands on the card (cuBLAS accumulates in fp32, rounds the output)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.matmul(a, b).float()
    return _dot32(a, b)


def hidden_mask(n: int, d_ff: int, seeds, keep_h: float, device, col0: int = 0, d_ff_total=None) -> torch.Tensor:
    """The (n, d_ff) hidden keep-mask of columns [col0, col0 + d_ff) of the
    whole (n, d_ff_total) hidden (None: d_ff, the one-process width)."""
    return hash_mask_slice((n, d_ff_total or d_ff), 1, col0, col0 + d_ff, seeds[0:2], keep_h, device)


def ffn_dropout_plain(x2, w1, b1, w2, b2, seeds, keep_h: float, keep_o: float, col0: int = 0,
                      d_ff_total=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, d) x -> (out (N, d), pre (N, d_ff)) in x's dtype; `seeds` are the
    four scrambled words [h0, h1, o0, o1]. `b2` None: out is the fp32
    partial product (see the module docstring, with `col0`, `d_ff_total`)."""
    cdt = x2.dtype
    n, d = x2.shape
    d_ff = w1.shape[0]
    pre = (_dot32(x2, w1.T) + b1.float()).to(cdt)
    h = gelu_as(pre.float())
    mh = hidden_mask(n, d_ff, seeds, keep_h, x2.device, col0, d_ff_total)
    hd = torch.where(mh, h * (1.0 / keep_h), 0.0).to(cdt)
    if b2 is None:
        return _dot32(hd, w2.T), pre
    out = _dot32(hd, w2.T) + b2.float()
    mo = hash_mask((n, d), seeds[2:4], keep_o, x2.device)
    return torch.where(mo, out * (1.0 / keep_o), 0.0).to(cdt), pre


def ffn_dropout_bwd_plain(g, x2, w1, w2, pre, seeds, keep_h: float, keep_o: float, col0: int = 0,
                          d_ff_total=None, partial: bool = False):
    """Cotangent g of `out` -> (dW1 (d_ff, d), db1, dW2 (d, d_ff), db2, dx),
    the weight gradients in the kernel's layout and fp32, dx in g's dtype
    (the compute dtype). `partial`: g is that of the fp32 partial product
    (no output mask; db2 None)."""
    cdt = x2.dtype
    n, d = x2.shape
    d_ff = w1.shape[0]
    pre32 = pre.float()
    if partial:
        g_out, db2 = g.float(), None
    else:
        mo = hash_mask((n, d), seeds[2:4], keep_o, g.device)
        g_out = torch.where(mo, g.float() * (1.0 / keep_o), 0.0)
        db2 = g_out.sum(dim=0)
    g_out_b = g_out.to(cdt)
    g_hd = _dot_lib(g_out_b, w2)  # (n, d_ff)
    mh = hidden_mask(n, d_ff, seeds, keep_h, g.device, col0, d_ff_total)
    inv_kh = torch.where(mh, 1.0 / keep_h, 0.0)
    phi = torch.exp(-0.5 * pre32 * pre32) * _INV_SQRT_2PI
    cdf = 0.5 * (1.0 + torch.erf(pre32 / _SQRT_2))
    g_pre = g_hd * inv_kh * (cdf + pre32 * phi)
    g_pre_b = g_pre.to(cdt)
    hd_b = (pre32 * cdf * inv_kh).to(cdt)
    db1 = g_pre.sum(dim=0)
    dw1 = _dot_lib(g_pre_b.T, x2)
    dw2 = _dot_lib(g_out_b.T, hd_b)
    dx = _dot_lib(g_pre_b, w1).to(cdt)
    return dw1, db1, dw2, db2, dx
