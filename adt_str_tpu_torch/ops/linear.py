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

The sum's order, for bf16 and fp16: one tensor-core product of 16 k a
step, k ascending, rounded to the element type, then the bias added and
rounded; for fp32: `acc = 0`, one `fma(x[r, k], W[c, k], acc)` a k in
ascending order, then `acc + b[c]`, all in fp32. The fp32 route (the
`compute_dtype: float32` configs' decode) runs each output's chain of K
FMAs on the CUDA cores: a block owns a strip of columns and every row up to
80, a thread 1-15 of the chains side by side, x's and W's k stages streamed
through a cp.async ring; the strips follow N (8 or 16 columns a block, or
132 strips split evenly, as the columns an SM would get), never M's bits.

`linear` is the wrapper the decode step calls:
- a CPU tensor runs `linear_plain`;
- a CUDA tensor on the inference path (no autograd graph being recorded)
  launches the kernel, which takes bf16 or fp16 (K % 8 == 0) or fp32 and
  raises on anything else;
- a CUDA tensor in training (grad enabled and an operand that requires it)
  runs `linear_plain` under autograd: the kernel has no backward.
`linear.launches` counts kernel launches. While `torch.export` traces,
`linear` records the op `adt_str_tpu_torch::linear` (`linear_op`), which
runs the kernel on CUDA tensors and `linear_plain` on CPU tensors.

The decode step calls `linear` 25 times a step, so its launch path is kept
short (`_build.launch`): no device switch when the tensor is on the current
device, the raw current stream, no copy of an operand already in the
kernel's layout.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from adt_str_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., K) x (N, K) weight (+ (N,) bias) -> (..., N) in `x`'s dtype; see
    the module docstring for which version runs."""
    if torch.compiler.is_exporting():
        return linear_op(x, weight, bias)
    if x.is_cpu or _build.records_grad(x, weight, bias):
        return linear_plain(x, weight, bias)
    return _launch(x, weight, bias)


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """One launch of the kernel on CUDA `x`, counted on `linear`."""
    if not x.is_cuda:
        raise ValueError(f"linear runs on cpu or cuda tensors, not {x.device}")
    K, N = x.shape[-1], weight.shape[0]
    if (x.dtype not in _DTYPE_CODE or weight.dim() != 2 or weight.shape[1] != K
            or (bias is not None and bias.shape != (N,)) or (x.dtype != torch.float32 and K % 8)):
        raise ValueError(f"the linear kernel takes bf16 or fp16 (K % 8 == 0) or fp32 x (..., K) with an (N, K) weight and "
                         f"an (N,) bias; got {x.dtype} {tuple(x.shape)}, weight {tuple(weight.shape)}, "
                         f"bias {None if bias is None else tuple(bias.shape)}")
    device = x.device
    if weight.device != device or (bias is not None and bias.device != device):
        raise ValueError(f"linear: weight and bias must lie on {device}")
    if not x.is_contiguous():
        x = x.contiguous()
    # w and b stay referenced until the launch: a cast copy freed before it could be handed to y
    w = weight if weight.dtype == x.dtype and weight.is_contiguous() else weight.to(x.dtype).contiguous()
    b = bias if bias is None or (bias.dtype == x.dtype and bias.is_contiguous()) else bias.to(x.dtype).contiguous()
    y = torch.empty((*x.shape[:-1], N), dtype=x.dtype, device=device)
    _build.check(_build.launch(device, _lib().launch_linear, x.data_ptr(), w.data_ptr(),
                               None if b is None else b.data_ptr(), y.data_ptr(), x.numel() // K, N, K,
                               _DTYPE_CODE[x.dtype]), "linear")
    linear.launches += 1
    return y


linear.launches = 0


def _run(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    return linear_plain(x, weight, bias) if x.is_cpu else _launch(x, weight, bias)


# `torch.ops.adt_str_tpu_torch.linear`: what `linear` records while exporting
linear_op = _build.register_op("linear", _run, lambda x, weight, bias: x.new_empty((*x.shape[:-1], weight.shape[0])))
