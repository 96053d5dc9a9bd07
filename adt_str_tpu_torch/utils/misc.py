"""Host utilities: the one logging setup the port's CLIs share, and the
switch that keeps fp32 matrix products true fp32.

`setup_logging` ports `adt_str_tpu/utils/misc.py:setup_logging` (its own copy).
"""

from __future__ import annotations

import functools
import logging

import torch


def setup_logging(log_level: str = "INFO") -> None:
    """One format for every CLI's log lines, at `log_level`; replaces any
    handler installed before (a plain basicConfig would then do nothing)."""
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S",
        level=getattr(logging, log_level.upper()),
        force=True,
    )


def fp32_products(fn):
    """Run `fn` with true fp32 products: matmul precision "highest" and
    cuDNN's TF32 off (no TF32 in a matmul or a convolution: the JAX
    package's `precision="highest"`), restoring the caller's settings after.
    The settings are process-wide, so they are set once at the outermost
    entry, and a nested entry that finds them already so leaves them alone."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        prev = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
        if prev == ("highest", False):
            return fn(*args, **kwargs)
        torch.set_float32_matmul_precision("highest")
        torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            torch.set_float32_matmul_precision(prev[0])
            torch.backends.cudnn.allow_tf32 = prev[1]

    return wrapped
