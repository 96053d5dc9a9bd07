"""Row LayerNorm with fp32 statistics (`csrc/layer_norm.cu`) and its plain version.

No TPU kernel is behind this one: it repairs a fault of the port. The plain
version takes its mean and variance with ATen's reductions, whose launch
shape follows the row count, so on the card a row's statistics, and from
them the decode's tokens, changed with the rows decoded beside it. The
kernel reduces each row with one warp in an order fixed by the width alone.

`layer_norm` is the wrapper the model calls:
- a CPU tensor runs `layer_norm_plain`;
- a CUDA tensor on the inference path (no autograd graph being recorded)
  launches the kernel, which takes fp32 or bf16 rows of at most 1,024 and
  raises on anything else;
- a CUDA tensor in training (grad enabled and an operand that requires it)
  runs `layer_norm_plain` under autograd: the kernel has no backward yet.
`layer_norm.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from adt_str_tpu_torch.ops import _build
from adt_str_tpu_torch.ops.linear import records_grad

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last dim with fp32 statistics (two passes: the
    mean, then the mean square deviation), cast back to `x`'s dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("layer_norm")
    p = ctypes.c_void_p
    lib.launch_layer_norm.argtypes = [p, p, p, p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, p]
    lib.launch_layer_norm.restype = ctypes.c_int
    lib.layer_norm_max_d.restype = ctypes.c_int
    return lib


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """(..., d) -> (..., d) in `x`'s dtype; see the module docstring for
    which version runs."""
    if x.device.type == "cpu" or records_grad(x, weight, bias):
        return layer_norm_plain(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm runs on cpu or cuda tensors, not {x.device}")
    d = x.shape[-1]
    lib = _lib()
    if x.dtype not in _DTYPE_CODE or not 0 < d <= lib.layer_norm_max_d() or weight.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"the layer_norm kernel takes fp32 or bf16 rows of 1..{lib.layer_norm_max_d()} with (d,) "
                         f"weight and bias; got {x.dtype} {tuple(x.shape)}, weight {tuple(weight.shape)}")
    if any(t.device != x.device for t in (weight, bias)):
        raise ValueError(f"layer_norm: weight and bias must lie on {x.device}")
    x = x.contiguous()
    w, b = (t.float().contiguous() for t in (weight, bias))
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.launch_layer_norm(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), x.numel() // d, d, eps,
                                    _DTYPE_CODE[x.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(err, "layer_norm")
    layer_norm.launches += 1
    return y


layer_norm.launches = 0
