"""Counter-based dropout-mask hash, bit for bit with the JAX package's
`_hash_mask`, `_fmix32` and `_seed_from_key` (`adt_str_tpu/models/transformer.py`).

A mask element is kept when the hash of its flat C-order index and two
scrambled seed words falls below `keep_threshold(keep)`. The model's
`dropout` (`models/transformer.py`), K4's plain version (`ops/ffn.py`) and
K4's kernel (`csrc/ffn_dropout.cu`, through `ops/cuda_ffn.py`) all draw
their masks from here, so the three agree for the same keys.

torch has no uint32 multiply, so the words live in int64 tensors below
2**32. A product of two such words can pass 2**63: it wraps in two's
complement (what int64 multiplication does on the CPU and the card), and
its low 32 bits, all that `& U32` keeps, are those of the uint32 product.
Every shift is taken after such a mask, so no wrapped high bit reaches the
low word.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

HASH_GOLDEN = 0x9E3779B9
HASH_M1 = 0x85EBCA6B
HASH_M2 = 0xC2B2AE35
U32 = 0xFFFFFFFF


def keep_threshold(keep: float) -> int:
    """The uint32 threshold the hash is compared with: a word is kept below it."""
    return min(int(keep * 2**32), 2**32 - 1)


def _hash_keep(idx: torch.Tensor, seed: Sequence[int], keep: float) -> torch.Tensor:
    """The keep decision of each int64 element index of `idx` (below 2**32)."""
    h = (idx * HASH_GOLDEN + int(seed[0])) & U32
    h = h ^ (h >> 16)
    h = ((h * HASH_M1) ^ int(seed[1])) & U32
    h = h ^ (h >> 15)
    return h < keep_threshold(keep)


def hash_mask(shape, seed: Sequence[int], keep: float, device=None) -> torch.Tensor:
    """Boolean keep-mask of `shape` from the two scrambled seed words: the
    hash of each element's flat C-order index (uint32 arithmetic)."""
    n = math.prod(int(d) for d in shape)
    if n > 2**32:
        raise ValueError(f"the hash indexes at most 2**32 elements, got {n}")
    return _hash_keep(torch.arange(n, dtype=torch.int64, device=device), seed, keep).reshape(tuple(shape))


def hash_mask_slice(global_shape, dim: int, start: int, stop: int, seed: Sequence[int], keep: float,
                    device=None) -> torch.Tensor:
    """`hash_mask(global_shape, ...)` narrowed to [start, stop) along `dim`,
    computed for those elements alone: each is hashed at its flat index in
    the unsharded tensor. A tensor-parallel shard (heads, FFN columns) so
    draws the mask the one-process step draws."""
    shape = [int(s) for s in global_shape]
    dim = dim % len(shape)
    if not 0 <= start <= stop <= shape[dim]:
        raise ValueError(f"slice [{start}, {stop}) out of dim {dim} of {tuple(shape)}")
    if math.prod(shape) > 2**32:
        raise ValueError(f"the hash indexes at most 2**32 elements, got {math.prod(shape)}")
    outer, inner = math.prod(shape[:dim]), math.prod(shape[dim + 1 :])
    o = torch.arange(outer, dtype=torch.int64, device=device)[:, None, None]
    j = torch.arange(start, stop, dtype=torch.int64, device=device)[None, :, None]
    i = torch.arange(inner, dtype=torch.int64, device=device)[None, None, :]
    idx = (o * shape[dim] + j) * inner + i
    return _hash_keep(idx, seed, keep).reshape(*shape[:dim], stop - start, *shape[dim + 1 :])


def fmix32(h: int) -> int:
    """murmur3 scalar finalizer on a Python int word."""
    h ^= h >> 16
    h = (h * HASH_M1) & U32
    h ^= h >> 13
    h = (h * HASH_M2) & U32
    return h ^ (h >> 16)


def seed_from_key(key: Sequence[int]) -> tuple[int, int]:
    """The two raw key words -> the two scrambled seed words of `hash_mask`."""
    d0, d1 = (int(w) & U32 for w in key)
    return fmix32((d0 * HASH_GOLDEN) & U32), fmix32((d1 + HASH_GOLDEN) & U32)
