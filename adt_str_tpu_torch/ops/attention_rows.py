"""Inference attention, the query rows of one item and head at a time
(`csrc/attention_rows.cu`), and its plain version.

No TPU kernel is behind this one: it repairs a fault of the port. The plain
version (the JAX package's `attention_core`: fp32 scores from the upcast q
and k, fp32 softmax, probabilities cast to v's dtype, then p . v) runs two
batched cuBLAS products, whose algorithm follows the batch, so on the card
the decode step's attention gave a row other bits beside other rows. The
kernel computes each query row on its own, every sum in an order fixed by
the head dim and the keys it reads.

`valid_keys` (an int, or None: all keys) stands for the decode step's mask
over its self-attention cache: keys 0..valid_keys-1 attend and every later
key takes `NEG_MASK`, as the JAX package's `decode_step` masks positions
past `step`. The plain version adds exactly that mask; the kernel reads only
the valid keys, which gives the same bits (a masked key's probability
underflows to 0 in fp32, and a product with 0 adds nothing).

`attention` is the wrapper the model calls:
- a CPU tensor runs `attention_plain`;
- a CUDA tensor on the inference path (no autograd graph being recorded)
  launches a kernel, which takes q, k, v of one dtype at any head dim and
  key count whose sum fits one block's shared memory (`MAX_FLOATS`: 57,856,
  so 55,808 keys at head dim 2,048), and raises on anything else; the route
  (`kernel_for`) is

      dtype        head dim                 design in csrc/attention_rows.cu
      bf16, fp16   1..256, a multiple of 8  "mma": cp.async ring into mma.sync
                                            (`attention`); past ~21,000 keys
                                            (`mma_max_keys`): "split"
      bf16, fp16   past 256                 "split": the keys cut into splits of
      fp32         any                      `keys_per_split(hd)`, a block an item,
                                            head and split, 16-byte loads
                                            (`attention_split`)

  (the configs JAX runs send at most `max_positions` encoder frames, 2,048
  by default, and a decode's `max_length` keys: JAX's position table does
  not take more frames);

- a CUDA tensor in training (grad enabled and an operand that requires it)
  runs `attention_plain` under autograd: the kernel has no backward.
`attention.launches` counts the mma design's launches, `attention_split.launches`
the split-key design's (one count a call of its three passes).
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct
from typing import Optional

import torch

from adt_str_tpu_torch.ops import _build
from adt_str_tpu_torch.ops.cuda_attention import NEG_MASK

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MMA_MAX_HEAD_DIM = 256  # `MMA_MAX_HD` in csrc/attention_rows.cu: 16-bit head dims past it take the split-key design
MAX_FLOATS = 57_856  # `MAX_FLOATS` in csrc/attention_rows.cu: head dim + keys a call at most
SMEM_MAX = 232_448  # one block's shared memory on the H100
SPLIT_MAX_KEYS = 256


def keys_per_split(hd: int) -> int:
    """The keys a split of the split-key design holds at head dim `hd`: a
    power of two near 16,384 elements of k a split (32..256), fewer where
    hd + keys would outgrow shared memory. It follows the head dim alone, so
    the number of splits, ceil(keys / keys_per_split(hd)), follows the head
    dim and the keys read and never the rows or the batch."""
    most = min(SPLIT_MAX_KEYS, max(32, 16384 // hd), MAX_FLOATS - hd)
    return 1 << (max(most, 1).bit_length() - 1)


def mma_max_keys(hd: int) -> int:
    """The most keys the mma design holds at one query row a block at a
    16-bit head dim `hd` <= 256 (`smem_bytes` in csrc/attention_rows.cu: its
    ring, query tile, a row's scores, chunk partials and sums)."""
    hdp = 32 if hd <= 32 else 64 if hd <= 64 else 128 if hd <= 128 else 256
    fixed = 2 * (4 * 64 + 16) * (hdp + 8) + 4 * (8 + 4 * (hdp + 8) + 8 + 2)
    return (SMEM_MAX - fixed) // (4 * 64) * 64


def kernel_for(dtype: torch.dtype, hd: int, n_keys: int) -> str:
    """The design that takes (dtype, head dim, keys read) on the card:
    "mma" or "split" (see the module docstring)."""
    if dtype in (torch.bfloat16, torch.float16) and hd <= MMA_MAX_HEAD_DIM and n_keys <= mma_max_keys(hd):
        return "mma"
    return "split"


def keys_mask(mask: Optional[torch.Tensor], valid_keys: Optional[int], tk: int,
              device: torch.device) -> Optional[torch.Tensor]:
    """The additive mask that `valid_keys` stands for ((1, 1, 1, tk) fp32:
    0 on keys below it, NEG_MASK from it on), or `mask` when it is None; a
    call gives one or the other, not both."""
    if valid_keys is None:
        return mask
    if mask is not None:
        raise ValueError("attention takes a mask or valid_keys, not both")
    return torch.where(torch.arange(tk, device=device) >= valid_keys, NEG_MASK, 0.0)[None, None, None, :]


def attention_probs(q: torch.Tensor, k: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd) + mask) in fp32, cast to q's dtype; `mask`
    is additive and broadcastable to (B, H, Tq, Tk)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores + mask.float()
    return torch.softmax(scores, dim=-1).to(q.dtype)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor],
                    valid_keys: Optional[int] = None) -> torch.Tensor:
    """(B, H, Tq, hd) x (B, H, Tk, hd) attention -> (B, H, Tq, hd)."""
    return torch.matmul(attention_probs(q, k, keys_mask(mask, valid_keys, k.shape[2], q.device)), v)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("attention_rows")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.launch_attention_rows.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, i, p, p]
    lib.launch_attention_rows.restype = ctypes.c_int
    lib.attention_rows_max_floats.restype = ctypes.c_int
    if lib.attention_rows_max_floats() != MAX_FLOATS:
        raise RuntimeError("csrc/attention_rows.cu's MAX_FLOATS differs from attention_rows'")
    return lib


def _kernel_layout(t: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """`t` (or a copy) with a contiguous last dim and, where the head dim is
    a multiple of 16 bytes' elements (always in bf16 and fp16), a 16-byte
    aligned start and row strides, and the strides of its first three dims
    (0 where a dim has one entry: never stepped)."""
    s0, s1, s2, s3 = t.stride()
    n0, n1, n2, hd = t.shape
    strides = (s0 if n0 > 1 else 0, s1 if n1 > 1 else 0, s2 if n2 > 1 else 0)
    vec = 16 // t.element_size()
    if s3 == 1 and ((t.dtype == torch.float32 and hd % vec) or (t.data_ptr() % 16 == 0
                                                               and (strides[0] | strides[1] | strides[2]) % vec == 0)):
        return t, strides
    t = t.clone(memory_format=torch.contiguous_format)
    s0, s1, s2, _ = t.stride()
    return t, (s0 if n0 > 1 else 0, s1 if n1 > 1 else 0, s2 if n2 > 1 else 0)


def _mask_strides(mask: torch.Tensor, shape: tuple[int, int, int, int]) -> tuple[int, ...]:
    """The element strides of `mask` broadcast to `shape` (0 on a broadcast dim)."""
    lead = 4 - mask.dim()
    if lead < 0 or any(n not in (1, m) for n, m in zip(mask.shape, shape[lead:])):
        raise ValueError(f"attention: a mask of shape {tuple(mask.shape)} does not broadcast to {shape}")
    return (0,) * lead + tuple(s if n > 1 else 0 for s, n in zip(mask.stride(), mask.shape))


def _check(q, k, v, mask, valid_keys) -> int:
    """The keys the kernel reads, after the checks both designs share."""
    B, H, Tq, hd = q.shape
    Tk = k.shape[2]
    n_keys = Tk if valid_keys is None else valid_keys
    dtype = q.dtype
    if (dtype not in _DTYPE_CODE or k.dtype != dtype or v.dtype != dtype or k.shape != (B, H, Tk, hd)
            or v.shape != k.shape or Tk < 1 or hd < 1 or hd + n_keys > MAX_FLOATS
            or (kernel_for(dtype, hd, n_keys) == "mma" and hd % 8) or not 1 <= n_keys <= Tk
            or (mask is not None and valid_keys is not None)):
        raise ValueError(f"the attention_rows kernel takes bf16 or fp16 (hd % 8 == 0 up to {MMA_MAX_HEAD_DIM}) or "
                         f"fp32 q (B, H, Tq, hd), k and v "
                         f"(B, H, Tk, hd) with hd + the keys read <= {MAX_FLOATS} and a mask or "
                         f"1 <= valid_keys <= Tk; got q {dtype} {tuple(q.shape)}, k {k.dtype} {tuple(k.shape)}, "
                         f"v {v.dtype} {tuple(v.shape)}, valid_keys {valid_keys}, "
                         f"mask {None if mask is None else tuple(mask.shape)}")
    device = q.device
    if k.device != device or v.device != device or (mask is not None and mask.device != device):
        raise ValueError(f"attention: every operand must lie on {device}")
    return n_keys


def _launch(q, k, v, mask, n_keys: int, ks: int) -> torch.Tensor:
    """One call of the C entry point: the mma design (`ks` 0) or the
    split-key design with splits of `ks` keys (its workspace allocated here)."""
    lib = _lib()
    B, H, Tq, hd = q.shape
    Tk = k.shape[2]
    (q, sq), (k, sk), (v, sv) = _kernel_layout(q), _kernel_layout(k), _kernel_layout(v)
    m, sm = None, (0, 0, 0, 0)
    if mask is not None:
        m = mask if mask.dtype == torch.float32 else mask.float()
        sm = _mask_strides(m, (B, H, Tq, Tk))
    out = torch.empty((B, H, Tq, hd), dtype=q.dtype, device=q.device)
    work = None
    if ks:
        splits = -(-n_keys // ks)
        work = torch.empty(B * H * Tq * splits * (ks + 1 + (hd if splits > 1 else 0)), dtype=torch.float32,
                           device=q.device)
    strides = struct.pack("13q", *sq, *sk, *sv, *sm)  # read by the C entry point before it returns
    _build.check(_build.launch(q.device, lib.launch_attention_rows, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               None if m is None else m.data_ptr(), out.data_ptr(), strides, B, H, Tq, Tk,
                               n_keys, hd, math.sqrt(hd), _DTYPE_CODE[q.dtype], ks,
                               None if work is None else work.data_ptr()), "attention_rows")
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None,
              valid_keys: Optional[int] = None) -> torch.Tensor:
    """(B, H, Tq, hd) q, (B, H, Tk, hd) k and v, an additive mask
    broadcastable to (B, H, Tq, Tk) or None, or `valid_keys` (see the module
    docstring) -> (B, H, Tq, hd) in q's dtype; see the module docstring for
    which version runs."""
    if q.is_cpu or _build.records_grad(q, k, v):
        return attention_plain(q, k, v, mask, valid_keys)
    if not q.is_cuda:
        raise ValueError(f"attention runs on cpu or cuda tensors, not {q.device}")
    n_keys = _check(q, k, v, mask, valid_keys)
    if kernel_for(q.dtype, q.shape[3], n_keys) == "split":
        return attention_split(q, k, v, mask, valid_keys)
    out = _launch(q, k, v, mask, n_keys, 0)
    attention.launches += 1
    return out


attention.launches = 0


def attention_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None,
                    valid_keys: Optional[int] = None) -> torch.Tensor:
    """`attention` through the split-key design, which `attention` sends
    the inputs `kernel_for` names "split"; `attention_plain` for CPU tensors
    and under autograd; on the card it raises on inputs of the mma design."""
    if q.is_cpu or _build.records_grad(q, k, v):
        return attention_plain(q, k, v, mask, valid_keys)
    if not q.is_cuda:
        raise ValueError(f"attention runs on cpu or cuda tensors, not {q.device}")
    n_keys = _check(q, k, v, mask, valid_keys)
    if kernel_for(q.dtype, q.shape[3], n_keys) != "split":
        raise ValueError(f"the split-key attention_rows kernel does not take {q.dtype} at head dim {q.shape[3]} over "
                         f"{n_keys} keys: the mma design does (`attention`)")
    out = _launch(q, k, v, mask, n_keys, keys_per_split(q.shape[3]))
    attention_split.launches += 1
    return out


attention_split.launches = 0
