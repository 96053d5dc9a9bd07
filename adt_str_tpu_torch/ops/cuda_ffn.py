"""K4: fused FFN + dropout forward kernel (`csrc/ffn_dropout.cu`).

Replaces `adt_str_tpu/ops/pallas_ffn.py:fused_ffn_dropout`. `ffn_dropout`
is the wrapper: the CUDA kernel for CUDA tensors (bf16, d and d_ff
multiples of `TILE`, as the JAX kernel asks), `ops/ffn.py:ffn_dropout_plain`
for CPU tensors, and nothing else; `ffn_dropout.launches` counts wrapper
calls that launch the kernel (its two GEMMs). `FusedFfnDropout` is the
autograd Function the model calls: it casts the fp32 parameters to the
compute dtype per call (as JAX does), passes both weights in the modules'
own layouts, saves the bf16 `pre`, and takes its backward from
`ffn_dropout_bwd_plain` (JAX's backward is XLA, not a kernel).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from adt_str_tpu_torch.ops import _build
from adt_str_tpu_torch.ops.dropout_hash import keep_threshold
from adt_str_tpu_torch.ops.ffn import ffn_dropout_bwd_plain, ffn_dropout_plain

TILE = 128  # `BN` in csrc/ffn_dropout.cu: d and d_ff are walked in output tiles of it


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ffn_dropout")
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.launch_ffn_dropout.argtypes = [p, p, p, p, p, p, p, p, i, i, i, u, u, u, u, u, u, f, f, p]
    lib.launch_ffn_dropout.restype = ctypes.c_int
    lib.ffn_dropout_tile.restype = ctypes.c_int
    if lib.ffn_dropout_tile() != TILE:
        raise RuntimeError("csrc/ffn_dropout.cu tile differs from cuda_ffn's")
    return lib


def ffn_dropout(x2, w1, b1, w2, b2, seeds, keep_h: float, keep_o: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, d) x -> (out (N, d), pre (N, d_ff)) through K4. `w1` is (d_ff, d)
    (`linear1.weight`'s layout), `w2` is (d, d_ff) (`linear2.weight`'s),
    biases (d_ff,) and (d,), all in x's dtype; `seeds` the four scrambled
    words [h0, h1, o0, o1]."""
    n, d = x2.shape
    d_ff = w1.shape[0]
    if w1.shape != (d_ff, d) or w2.shape != (d, d_ff) or b1.shape != (d_ff,) or b2.shape != (d,) or len(seeds) != 4:
        raise ValueError(
            f"ffn_dropout shapes: x {tuple(x2.shape)} w1 {tuple(w1.shape)} b1 {tuple(b1.shape)} "
            f"w2 {tuple(w2.shape)} b2 {tuple(b2.shape)} seeds {len(seeds)}"
        )
    if x2.device.type == "cpu":
        return ffn_dropout_plain(x2, w1, b1, w2, b2, seeds, keep_h, keep_o)
    if x2.device.type != "cuda":
        raise ValueError(f"ffn_dropout runs on cpu or cuda tensors, not {x2.device}")
    if any(t.dtype != torch.bfloat16 for t in (x2, w1, b1, w2, b2)) or d % TILE or d_ff % TILE or n < 1:
        raise ValueError(
            f"the FFN kernel takes bf16 operands with d and d_ff multiples of {TILE}; "
            f"got {x2.dtype}, d={d}, d_ff={d_ff}, N={n}"
        )
    lib = _lib()
    x2, w1, b1, w2, b2 = (t.contiguous() for t in (x2, w1, b1, w2, b2))
    out = torch.empty((n, d), dtype=x2.dtype, device=x2.device)
    pre = torch.empty((n, d_ff), dtype=x2.dtype, device=x2.device)
    hd = torch.empty_like(pre)  # the dropped hidden, between the two GEMMs
    with torch.cuda.device(x2.device):
        err = lib.launch_ffn_dropout(
            x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), pre.data_ptr(), hd.data_ptr(), n, d, d_ff, *(int(s) for s in seeds),
            keep_threshold(keep_h), keep_threshold(keep_o), 1.0 / keep_h, 1.0 / keep_o,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "ffn_dropout")
    ffn_dropout.launches += 1
    return out, pre


ffn_dropout.launches = 0


class FusedFfnDropout(torch.autograd.Function):
    """`drop_o(drop_h(gelu(x2 W1 + b1)) W2 + b2)` for (N, d) x2 in the
    compute dtype and the fp32 `linear1` / `linear2` parameters; the seeds
    get no gradient."""

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, seeds, keep_h: float, keep_o: float):
        cdt = x2.dtype
        w1c, w2c = w1.to(cdt), w2.to(cdt)
        out, pre = ffn_dropout(x2, w1c, b1.to(cdt), w2c, b2.to(cdt), seeds, keep_h, keep_o)
        ctx.save_for_backward(x2, w1c, w2c, pre)
        ctx.seeds, ctx.keep = seeds, (keep_h, keep_o)
        return out

    @staticmethod
    def backward(ctx, g):
        x2, w1c, w2c, pre = ctx.saved_tensors
        dw1, db1, dw2, db2, dx = ffn_dropout_bwd_plain(g, x2, w1c, w2c, pre, ctx.seeds, *ctx.keep)
        return dx, dw1, db1, dw2, db2, None, None, None
