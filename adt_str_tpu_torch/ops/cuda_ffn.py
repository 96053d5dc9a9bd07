"""K4: fused FFN + dropout forward kernels (`csrc/ffn_dropout.cu`,
`csrc/ffn_dropout_tf32.cu`).

Replaces `adt_str_tpu/ops/pallas_ffn.py:fused_ffn_dropout`, which runs in
the compute dtype. `ffn_dropout` is the wrapper: the CUDA kernels for CUDA
tensors, `ops/ffn.py:ffn_dropout_plain` for CPU tensors, and nothing else;
each wrapper's `launches` counts its calls that launch its kernel (two
GEMMs). On the card (`kernel_for`) d is a multiple of `TILE`, as JAX's gate
asks, and d_ff is any width:

    dtype        route: kernel (wrapper)
    bf16, fp16   "hopper": csrc/ffn_dropout.cu, TMA + wgmma (ffn_dropout)
    fp32         "tf32x3": csrc/ffn_dropout_tf32.cu, TMA + wgmma in 3xTF32
                 (ffn_dropout_tf32)

Both walk d_ff in tiles of `TILE`: a d_ff that is not a multiple of it is
padded here with zero rows of W1, zeros of b1 and zero columns of W2 up to
the next multiple (the padded columns give pre = 0, gelu(0) = 0 and add
nothing), and `pre` is cut back to d_ff. TMA needs 16-byte row strides,
which the padded width always has. The hidden mask stays keyed on the real
width: `col0` and `d_ff_total` go to the kernel unchanged. `FusedFfnDropout` is the
autograd Function the model calls: it casts the fp32 parameters to the
compute dtype per call (as JAX does), passes both weights in the modules'
own layouts, saves the bf16 `pre`, and takes its backward from
`ffn_dropout_bwd_plain` (JAX's backward is XLA, not a kernel).

Under tensor parallelism both take a rank's d_ff columns: `col0`, the
first of them in the whole width `d_ff_total`, keys the hidden mask, and
`b2` None asks for the partial mode, in which GEMM 2 writes the fp32
`hd W2_shard^T` without b2 and the output dropout (`ops/ffn.py`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from adt_str_tpu_torch.ops import _build
from adt_str_tpu_torch.ops.dropout_hash import keep_threshold
from adt_str_tpu_torch.ops.ffn import ffn_dropout_bwd_plain, ffn_dropout_plain

TILE = 128  # `BN` in csrc/ffn_dropout.cu and csrc/ffn_dropout_tf32.cu: d and d_ff are walked in output tiles of it
_DTYPE_CODE = {torch.bfloat16: 1, torch.float16: 2}  # csrc/ffn_dropout.cu's


def kernel_for(dtype: torch.dtype, d: int, d_ff: int) -> str:
    """The K4 kernel that takes operands of `dtype` at widths d, d_ff on the
    card: "hopper" (bf16 or fp16: TMA + wgmma) or "tf32x3" (fp32: TMA +
    wgmma, each product as three TF32 products). Raises a ValueError on
    another dtype, on a d that is not a multiple of `TILE` (JAX's gate sends
    d % 128 == 0 only) or d_ff < 1."""
    if d % TILE or d < TILE or d_ff < 1:
        raise ValueError(f"the FFN kernels take d a multiple of {TILE} and d_ff >= 1; got d={d}, d_ff={d_ff}")
    if dtype in _DTYPE_CODE:
        return "hopper"
    if dtype == torch.float32:
        return "tf32x3"
    raise ValueError(f"the FFN kernels take bf16, fp16 or fp32 operands; got {dtype}")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ffn_dropout")
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.launch_ffn_dropout.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, u, u, u, u, u, u, f, f, i, p]
    lib.launch_ffn_dropout.restype = ctypes.c_int
    lib.ffn_dropout_tile.restype = ctypes.c_int
    if lib.ffn_dropout_tile() != TILE:
        raise RuntimeError("csrc/ffn_dropout.cu tile differs from cuda_ffn's")
    return lib


@functools.cache
def _tf32_lib() -> ctypes.CDLL:
    lib = _build.load("ffn_dropout_tf32")
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.launch_ffn_dropout_tf32.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, u, u, u, u, u, u, f, f, p]
    lib.launch_ffn_dropout_tf32.restype = ctypes.c_int
    lib.ffn_dropout_tf32_tile.restype = ctypes.c_int
    if lib.ffn_dropout_tf32_tile() != TILE:
        raise RuntimeError("csrc/ffn_dropout_tf32.cu tile differs from cuda_ffn's")
    return lib


def _check(x2, w1, b1, w2, b2, seeds, col0: int, d_ff_total) -> tuple[int, int, int, int]:
    """-> (N, d, d_ff, d_ff_total) after the shape checks of both kernels."""
    n, d = x2.shape
    d_ff = w1.shape[0]
    total = d_ff if d_ff_total is None else int(d_ff_total)
    if (w1.shape != (d_ff, d) or w2.shape != (d, d_ff) or b1.shape != (d_ff,)
            or (b2 is not None and b2.shape != (d,)) or len(seeds) != 4 or not 0 <= col0 <= total - d_ff):
        raise ValueError(
            f"ffn_dropout shapes: x {tuple(x2.shape)} w1 {tuple(w1.shape)} b1 {tuple(b1.shape)} "
            f"w2 {tuple(w2.shape)} b2 {None if b2 is None else tuple(b2.shape)} seeds {len(seeds)}, "
            f"columns {col0}..{col0 + d_ff} of {total}"
        )
    if not (x2.is_cpu or x2.is_cuda):
        raise ValueError(f"ffn_dropout runs on cpu or cuda tensors, not {x2.device}")
    if x2.is_cuda:
        operands = (x2, w1, b1, w2) if b2 is None else (x2, w1, b1, w2, b2)
        if any(t.dtype != x2.dtype for t in operands) or n < 1:
            raise ValueError(f"the FFN kernels take operands of one dtype and N >= 1; got "
                             f"{[t.dtype for t in operands]}, N={n}")
        kernel_for(x2.dtype, d, d_ff)
    return n, d, d_ff, total


def padded_weights(w1, b1, w2) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """W1 (d_ff, d), b1 and W2 (d, d_ff) with zeros on to the next multiple
    of `TILE` columns of the hidden (the same tensors when d_ff is one)."""
    pad = -w1.shape[0] % TILE
    if pad == 0:
        return w1, b1, w2
    f = torch.nn.functional.pad
    return f(w1, (0, 0, 0, pad)), f(b1, (0, pad)), f(w2, (0, pad))


def _launch(fn, x2, w1, b1, w2, b2, seeds, keep_h, keep_o, col0, total, *dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Both GEMMs of a K4 kernel's C entry `fn` (`dtype`: its dtype code,
    where it takes one): -> (out, pre)."""
    n, d = x2.shape
    d_ff = w1.shape[0]
    w1, b1, w2 = padded_weights(w1, b1, w2)
    x2, w1, b1, w2 = (t.contiguous() for t in (x2, w1, b1, w2))
    b2 = None if b2 is None else b2.contiguous()
    out = torch.empty((n, d), dtype=torch.float32 if b2 is None else x2.dtype, device=x2.device)
    pre = torch.empty((n, w1.shape[0]), dtype=x2.dtype, device=x2.device)
    hd = torch.empty_like(pre)  # the dropped hidden, between the two GEMMs
    err = _build.launch(
        x2.device, fn, x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        None if b2 is None else b2.data_ptr(), out.data_ptr(), pre.data_ptr(), hd.data_ptr(), n, d, w1.shape[0],
        total, col0, *(int(s) for s in seeds), keep_threshold(keep_h), keep_threshold(keep_o), 1.0 / keep_h,
        1.0 / keep_o, *dtype)
    _build.check(err, fn.__name__)
    return out, pre if pre.shape[1] == d_ff else pre[:, :d_ff]


def ffn_dropout(x2, w1, b1, w2, b2, seeds, keep_h: float, keep_o: float, col0: int = 0,
                d_ff_total=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, d) x -> (out (N, d), pre (N, d_ff)) through K4. `w1` is (d_ff, d)
    (`linear1.weight`'s layout), `w2` is (d, d_ff) (`linear2.weight`'s),
    biases (d_ff,) and (d,), all in x's dtype; `seeds` the four scrambled
    words [h0, h1, o0, o1]. `col0`, `d_ff_total` (None: d_ff) and `b2`
    None (out: the fp32 partial product) as in the module docstring."""
    n, d, d_ff, total = _check(x2, w1, b1, w2, b2, seeds, col0, d_ff_total)
    if x2.is_cpu:
        return ffn_dropout_plain(x2, w1, b1, w2, b2, seeds, keep_h, keep_o, col0, d_ff_total)
    if kernel_for(x2.dtype, d, d_ff) == "tf32x3":
        return ffn_dropout_tf32(x2, w1, b1, w2, b2, seeds, keep_h, keep_o, col0, d_ff_total)
    out, pre = _launch(_lib().launch_ffn_dropout, x2, w1, b1, w2, b2, seeds, keep_h, keep_o, col0, total,
                       _DTYPE_CODE[x2.dtype])
    ffn_dropout.launches += 1
    return out, pre


ffn_dropout.launches = 0


def ffn_dropout_tf32(x2, w1, b1, w2, b2, seeds, keep_h: float, keep_o: float, col0: int = 0,
                     d_ff_total=None) -> tuple[torch.Tensor, torch.Tensor]:
    """K4 in fp32 on the tensor cores in 3xTF32 (`csrc/ffn_dropout_tf32.cu`),
    as `ffn_dropout` for fp32 operands (`ffn_dropout` sends them here);
    `ffn_dropout_plain` for CPU tensors."""
    n, d, d_ff, total = _check(x2, w1, b1, w2, b2, seeds, col0, d_ff_total)
    if x2.is_cpu:
        return ffn_dropout_plain(x2, w1, b1, w2, b2, seeds, keep_h, keep_o, col0, d_ff_total)
    if x2.dtype != torch.float32:
        raise ValueError(f"the fp32 FFN kernel takes fp32 operands; got {x2.dtype}")
    out, pre = _launch(_tf32_lib().launch_ffn_dropout_tf32, x2, w1, b1, w2, b2, seeds, keep_h, keep_o, col0, total)
    ffn_dropout_tf32.launches += 1
    return out, pre


ffn_dropout_tf32.launches = 0


class FusedFfnDropout(torch.autograd.Function):
    """`drop_o(drop_h(gelu(x2 W1 + b1)) W2 + b2)` for (N, d) x2 in the
    compute dtype and the fp32 `linear1` / `linear2` parameters; the seeds
    get no gradient. `b2` None: the fp32 partial `drop_h(...) W2^T` of a
    tensor-parallel rank's columns from `col0` of `d_ff_total`."""

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, seeds, keep_h: float, keep_o: float, col0: int = 0, d_ff_total=None):
        cdt = x2.dtype
        w1c, w2c = w1.to(cdt), w2.to(cdt)
        out, pre = ffn_dropout(x2, w1c, b1.to(cdt), w2c, None if b2 is None else b2.to(cdt), seeds, keep_h, keep_o,
                               col0, d_ff_total)
        ctx.save_for_backward(x2, w1c, w2c, pre)
        ctx.seeds, ctx.keep, ctx.cols, ctx.partial = seeds, (keep_h, keep_o), (col0, d_ff_total), b2 is None
        return out

    @staticmethod
    def backward(ctx, g):
        x2, w1c, w2c, pre = ctx.saved_tensors
        dw1, db1, dw2, db2, dx = ffn_dropout_bwd_plain(g, x2, w1c, w2c, pre, ctx.seeds, *ctx.keep, *ctx.cols,
                                                       partial=ctx.partial)
        return dx, dw1, db1, dw2, db2, None, None, None, None, None
