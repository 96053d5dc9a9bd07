"""Row LayerNorm with fp32 statistics, alone or after the residual add
(`csrc/layer_norm.cu`), and their plain versions.

No TPU kernel is behind this one: it repairs a fault of the port. The plain
version takes its mean and variance with ATen's reductions, whose launch
shape follows the row count, so on the card a row's statistics, and from
them the decode's tokens, changed with the rows decoded beside it. The
kernel reduces each row with one warp in an order fixed by the width alone.

`layer_norm(x, ...)` and `add_layer_norm(x, r, ...)` (`LayerNorm(x + r)`,
the sum rounded to `x`'s dtype first, as ATen's add rounds it, so the fused
call is bit-equal to `layer_norm(x + r)`) are the wrappers the model calls:
- a CPU tensor runs the plain version;
- a CUDA tensor on the inference path (no autograd graph being recorded)
  launches the kernel, which takes fp32, bf16 or fp16 rows of any width
  (a lane keeps its values in registers up to d 1,024; wider rows are read
  again from device memory on each pass, with the same sums in the same
  order) and raises on anything else;
- a CUDA tensor in training (grad enabled and an operand that requires it)
  runs the plain version under autograd: the kernel has no backward.
`layer_norm.launches` counts the kernel's launches from both wrappers.
While `torch.export` traces, the wrappers record the ops
`adt_str_tpu_torch::layer_norm` and `::add_layer_norm`, which run the kernel
on CUDA tensors and the plain versions on CPU tensors.

The decode step calls it 12 times a step, so its launch path is
`_build.launch` (no device switch on the current device, the raw current
stream) and copies no operand already in the kernel's layout.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from adt_str_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last dim with fp32 statistics (two passes: the
    mean, then the mean square deviation), cast back to `x`'s dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def add_layer_norm_plain(x: torch.Tensor, r: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         eps: float) -> torch.Tensor:
    """`layer_norm_plain(x + r)`: the sum in `x`'s dtype, then the LayerNorm."""
    return layer_norm_plain(x + r, weight, bias, eps)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("layer_norm")
    p = ctypes.c_void_p
    lib.launch_layer_norm.argtypes = [p, p, p, p, p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                      p]
    lib.launch_layer_norm.restype = ctypes.c_int
    return lib


def _launch(x: torch.Tensor, r: Optional[torch.Tensor], weight: torch.Tensor, bias: torch.Tensor,
            eps: float) -> torch.Tensor:
    """The kernel on CUDA `x` (and `r`, the residual, or None)."""
    if not x.is_cuda:
        raise ValueError(f"layer_norm runs on cpu or cuda tensors, not {x.device}")
    d = x.shape[-1]
    if (x.dtype not in _DTYPE_CODE or d < 1 or weight.shape != (d,) or bias.shape != (d,)
            or (r is not None and (r.shape != x.shape or r.dtype != x.dtype))):
        raise ValueError(f"the layer_norm kernel takes fp32, bf16 or fp16 rows of d >= 1 (a residual of x's shape and "
                         f"dtype) with (d,) weight and bias; got {x.dtype} {tuple(x.shape)}, residual "
                         f"{None if r is None else (r.dtype, tuple(r.shape))}, weight {tuple(weight.shape)}")
    device = x.device
    if any(t.device != device for t in (weight, bias)) or (r is not None and r.device != device):
        raise ValueError(f"layer_norm: weight, bias and residual must lie on {device}")
    if not x.is_contiguous():
        x = x.contiguous()
    if r is not None and not r.is_contiguous():
        r = r.contiguous()
    # w and b stay referenced until the launch: a cast copy freed before it could be handed to y
    w = weight if weight.dtype == torch.float32 and weight.is_contiguous() else weight.float().contiguous()
    b = bias if bias.dtype == torch.float32 and bias.is_contiguous() else bias.float().contiguous()
    y = torch.empty_like(x)
    _build.check(_build.launch(device, _lib().launch_layer_norm, x.data_ptr(), None if r is None else r.data_ptr(),
                               w.data_ptr(), b.data_ptr(), y.data_ptr(), x.numel() // d, d, eps,
                               _DTYPE_CODE[x.dtype]), "layer_norm")
    layer_norm.launches += 1
    return y


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """(..., d) -> (..., d) in `x`'s dtype; see the module docstring for
    which version runs."""
    if torch.compiler.is_exporting():
        return layer_norm_op(x, weight, bias, eps)
    if x.is_cpu or _build.records_grad(x, weight, bias):
        return layer_norm_plain(x, weight, bias, eps)
    return _launch(x, None, weight, bias, eps)


def add_layer_norm(x: torch.Tensor, r: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """`LayerNorm(x + r)`: (..., d) x and r of one dtype -> (..., d); see the
    module docstring for which version runs."""
    if torch.compiler.is_exporting():
        return add_layer_norm_op(x, r, weight, bias, eps)
    if x.is_cpu or _build.records_grad(x, r, weight, bias):
        return add_layer_norm_plain(x, r, weight, bias, eps)
    return _launch(x, r, weight, bias, eps)


layer_norm.launches = 0


def _run(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    return layer_norm_plain(x, weight, bias, eps) if x.is_cpu else _launch(x, None, weight, bias, eps)


def _run_add(x: torch.Tensor, r: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    return add_layer_norm_plain(x, r, weight, bias, eps) if x.is_cpu else _launch(x, r, weight, bias, eps)


# `torch.ops.adt_str_tpu_torch.layer_norm` and `.add_layer_norm`: what the wrappers record while exporting
layer_norm_op = _build.register_op("layer_norm", _run, lambda x, weight, bias, eps: x.new_empty(x.shape))
add_layer_norm_op = _build.register_op("add_layer_norm", _run_add, lambda x, r, weight, bias, eps: x.new_empty(x.shape))
