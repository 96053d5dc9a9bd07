"""Inference product `x W^T + b` (`csrc/linear.cu`) and its plain version.

No TPU kernel is behind this one: it repairs a fault of the port. The plain
version goes to cuBLAS, which picks its algorithm by the shape, so on the
card a decode step's product (and from it the decode's tokens) changed
with the number of rows beside it. The kernel sums every output element
over K in one order for every row count: no split of K, no choice by M.
Bit-invariance is needed where tokens are decoded, so the decode step's
products call `linear` (`models/decode.py`, `fixed_order=True` in
`models/transformer.py`); the encoder's products, the memory's K/V
projections and the teacher-forced decoder of training and its eval loss
run `linear_plain`, cuBLAS.

`linear` is the wrapper the decode step calls:
- a CPU tensor runs `linear_plain`;
- a CUDA tensor on the inference path (no autograd graph being recorded)
  launches the kernel, which takes bf16 (K % 8 == 0) or fp32 and raises on
  anything else;
- a CUDA tensor in training (grad enabled and an operand that requires it)
  runs `linear_plain` under autograd: the kernel has no backward.
`linear.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from adt_str_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def linear_plain(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """`x @ W^T + b` in `x`'s dtype: the product rounded, then the bias added
    (the JAX package's rounding points)."""
    y = x @ weight.to(x.dtype).T
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("linear")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.launch_linear.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.launch_linear.restype = ctypes.c_int
    return lib


def records_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether autograd records an op on these operands: the training path."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., K) x (N, K) weight (+ (N,) bias) -> (..., N) in `x`'s dtype; see
    the module docstring for which version runs."""
    if x.device.type == "cpu" or records_grad(x, weight, bias):
        return linear_plain(x, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"linear runs on cpu or cuda tensors, not {x.device}")
    K, N = x.shape[-1], weight.shape[0]
    if (x.dtype not in _DTYPE_CODE or weight.dim() != 2 or weight.shape[1] != K
            or (bias is not None and bias.shape != (N,)) or (x.dtype == torch.bfloat16 and K % 8)):
        raise ValueError(f"the linear kernel takes bf16 (K % 8 == 0) or fp32 x (..., K) with an (N, K) weight and "
                         f"an (N,) bias; got {x.dtype} {tuple(x.shape)}, weight {tuple(weight.shape)}, "
                         f"bias {None if bias is None else tuple(bias.shape)}")
    if any(t is not None and t.device != x.device for t in (weight, bias)):
        raise ValueError(f"linear: weight and bias must lie on {x.device}")
    x2 = x.reshape(-1, K).contiguous()
    w = weight.to(x.dtype).contiguous()
    b = None if bias is None else bias.to(x.dtype).contiguous()
    y = torch.empty((x2.shape[0], N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().launch_linear(x2.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
                                   x2.shape[0], N, K, _DTYPE_CODE[x.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(err, "linear")
    linear.launches += 1
    return y.reshape(*x.shape[:-1], N)


linear.launches = 0
