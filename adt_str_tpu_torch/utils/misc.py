"""Host utilities: the one logging setup the port's CLIs share, the
switch that keeps fp32 matrix products true fp32, and the reference's small
file, array and HDF5 helpers.

`setup_logging`, `file_shuffle`, `my_vstack`, `pad_arrays`,
`get_random_mode`, `create_one_hot`, `save_to_hdf` and
`save_to_hdf_variations` port `adt_str_tpu/utils/misc.py` (its own copy;
the HDF5 writers take an open h5py file or group).
"""

from __future__ import annotations

import functools
import logging
import random
from collections import Counter
from pathlib import Path

import numpy as np
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


def file_shuffle(files: list, seed_fix: bool) -> list:
    """Sorted by path; with `seed_fix`, shuffled by `random.Random(1)`."""
    files = sorted(files, key=lambda x: str(Path(x)))
    if seed_fix:
        random.Random(1).shuffle(files)
    return files


def my_vstack(array1, array2):
    """`np.vstack` that passes an empty side through."""
    if len(array1) == 0:
        return array2
    if len(array2) == 0:
        return array1
    return np.vstack((array1, array2))


def pad_arrays(array1: np.ndarray, array2: np.ndarray):
    """Zero-pad the shorter of two 1-D arrays to the longer's length."""
    len1, len2 = len(array1), len(array2)
    if len1 > len2:
        array2 = np.pad(array2, (0, len1 - len2), mode="constant")
    elif len2 > len1:
        array1 = np.pad(array1, (0, len2 - len1), mode="constant")
    return array1, array2


def get_random_mode(lst, rng: random.Random | None = None):
    """The most frequent element, a random one among ties (`rng`, else the
    `random` module's generator)."""
    counter = Counter(lst)
    max_count = max(counter.values())
    modes = [key for key, count in counter.items() if count == max_count]
    return (rng or random).choice(modes)


def create_one_hot(length: int, index: int) -> np.ndarray:
    one_hot = np.zeros(length, dtype=np.float32)
    one_hot[index] = 1.0
    return one_hot


def save_to_hdf(hf, inst_group, wav_seg, tokens) -> None:
    """Write the next `seg{N}` group (`wav`, and `midi` when `tokens` is
    given) under `inst_group` (None: the file's root)."""
    group = hf if inst_group is None else hf.require_group(inst_group)
    seg_group = group.create_group(f"seg{len(group.keys())}")
    seg_group.create_dataset("wav", data=wav_seg)
    if tokens is not None:
        seg_group.create_dataset("midi", data=tokens)


def save_to_hdf_variations(hf, inst_group, wav_seg, tokens) -> None:
    """As `save_to_hdf`, with three token variations `midi0`-`midi2`."""
    group = hf if inst_group is None else hf.require_group(inst_group)
    seg_group = group.create_group(f"seg{len(group.keys())}")
    seg_group.create_dataset("wav", data=wav_seg)
    if tokens is not None:
        for i in range(3):
            seg_group.create_dataset(f"midi{i}", data=tokens[i])
