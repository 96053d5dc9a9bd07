"""Inference attention a query row at a time (`csrc/attention_rows.cu`) and
its plain version.

No TPU kernel is behind this one: it repairs a fault of the port. The plain
version (the JAX package's `attention_core`: fp32 scores from the upcast q
and k, fp32 softmax, probabilities cast to v's dtype, then p . v) runs two
batched cuBLAS products, whose algorithm follows the batch, so on the card
the decode step's attention gave a row other bits beside other rows. The
kernel computes each query row of each head on its own, every sum in an
order fixed by the head dim and the key count.

`attention` is the wrapper the model calls:
- a CPU tensor runs `attention_plain`;
- a CUDA tensor on the inference path (no autograd graph being recorded)
  launches the kernel, which takes bf16 or fp32 q, k, v of one dtype with
  1..4,096 keys and a head dim of 1..256, and raises on anything else;
- a CUDA tensor in training (grad enabled and an operand that requires it)
  runs `attention_plain` under autograd: the kernel has no backward.
`attention.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from adt_str_tpu_torch.ops import _build
from adt_str_tpu_torch.ops.linear import records_grad

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def attention_probs(q: torch.Tensor, k: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd) + mask) in fp32, cast to q's dtype; `mask`
    is additive and broadcastable to (B, H, Tq, Tk)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores + mask.float()
    return torch.softmax(scores, dim=-1).to(q.dtype)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, H, Tq, hd) x (B, H, Tk, hd) attention -> (B, H, Tq, hd)."""
    return torch.matmul(attention_probs(q, k, mask), v)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("attention_rows")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.launch_attention_rows.argtypes = [p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, i, p]
    lib.launch_attention_rows.restype = ctypes.c_int
    lib.attention_rows_max_keys.restype = lib.attention_rows_max_head_dim.restype = ctypes.c_int
    return lib


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, Tq, hd) q, (B, H, Tk, hd) k and v, an additive mask
    broadcastable to (B, H, Tq, Tk) or None -> (B, H, Tq, hd) in q's dtype;
    see the module docstring for which version runs."""
    if q.device.type == "cpu" or records_grad(q, k, v):
        return attention_plain(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on cpu or cuda tensors, not {q.device}")
    lib = _lib()
    B, H, Tq, hd = q.shape
    Tk = k.shape[2]
    if (q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype or k.shape != (B, H, Tk, hd)
            or v.shape != k.shape or not 1 <= Tk <= lib.attention_rows_max_keys()
            or not 1 <= hd <= lib.attention_rows_max_head_dim()):
        raise ValueError(f"the attention_rows kernel takes bf16 or fp32 q (B, H, Tq, hd), k and v (B, H, Tk, hd) "
                         f"with 1 <= Tk <= {lib.attention_rows_max_keys()} and hd <= "
                         f"{lib.attention_rows_max_head_dim()}; got q {q.dtype} {tuple(q.shape)}, k {k.dtype} "
                         f"{tuple(k.shape)}, v {v.dtype} {tuple(v.shape)}")
    if any(t.device != q.device for t in (k, v) + (() if mask is None else (mask,))):
        raise ValueError(f"attention: every operand must lie on {q.device}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    m = None if mask is None else mask.float().expand(B, H, Tq, Tk)
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *(m.stride() if m is not None else (0,) * 4))
    c_strides = (ctypes.c_longlong * 13)(*strides)
    out = torch.empty((B, H, Tq, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.launch_attention_rows(q.data_ptr(), k.data_ptr(), v.data_ptr(), None if m is None else m.data_ptr(),
                                        out.data_ptr(), c_strides, B, H, Tq, Tk, hd, math.sqrt(hd),
                                        _DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(err, "attention_rows")
    attention.launches += 1
    return out


attention.launches = 0
