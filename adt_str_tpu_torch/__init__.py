"""PyTorch + CUDA port of `adt_str_tpu` for NVIDIA Hopper (H100).

The JAX package `adt_str_tpu` is the reference this package is tested
against; nothing here imports it or JAX. Module names follow the JAX
package so each port module's counterpart is easy to find.

Devices: public entry points run on `cuda` unless the caller passes
`device="cpu"` (as the CPU tests do). With no device and no CUDA they
raise — they never fall back to the CPU on their own.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a `torch.device`; None means `cuda`, which must exist."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name ('bfloat16', 'float32', ...) -> torch dtype."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype
