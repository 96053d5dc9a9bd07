"""The plain reference the benchmark holds the port to: plain PyTorch in
fp32 with TF32 off, written from the model's, the synthesiser's and the
optimizer's published arithmetic. It imports neither JAX, nor the JAX
package, nor anything of the port, and takes nothing the port has made."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def true_fp32():
    """Products in true fp32 while the block runs (TF32 off for matmuls and
    cuDNN), the caller's settings restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, \
        torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]
        torch.set_float32_matmul_precision(prev[2])
