"""K2 gather + mixup blend (`csrc/gather_blend.cu`) and K3 note placement
(`csrc/place_notes.cu`).

Replace `adt_str_tpu/synth/pallas_place.py:gather_blend` and `place_notes`.
`gather_blend` and `place_notes` are the wrappers: the CUDA kernel for CUDA
tensors, the plain version of `ops/place.py` for CPU tensors, and nothing
else; each wrapper's `launches` counts kernel launches. The kernels are
bit-equal to the plain versions (`torch.equal` on the card).

Row ids outside [0, n_rows), slots outside [0, S) and onsets outside
[0, chunk_samples) are clamped into their range by the kernels and the plain
versions alike (as JAX's gathers clamp), so bad ids read no memory out of
bounds and both devices give the same result, with no synchronisation.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from adt_str_tpu_torch.ops import _build
from adt_str_tpu_torch.ops.place import gather_blend_plain, place_notes_plain

# the `dtype` argument of both C entry points
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# int arguments of each C entry point, between its five pointers and the stream
_INT_ARGS = {"gather_blend": 4, "place_notes": 6}


@functools.cache
def _launcher(name: str):
    fn = getattr(_build.load(name), f"launch_{name}")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * _INT_ARGS[name] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _same_cuda_device(what: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, not {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: all operands must lie on {dev}")


def gather_blend(table: torch.Tensor, idx_main: torch.Tensor, idx_sub: torch.Tensor,
                 lam: torch.Tensor) -> torch.Tensor:
    """(n_rows, L) bank, (N,) main and sub row ids, (N,) f32 mixup weights
    -> (N, L) blends in the table's dtype, through K2."""
    if table.dim() != 2 or table.shape[0] == 0 or idx_main.shape != idx_sub.shape or idx_main.shape != lam.shape or idx_main.dim() != 1:
        raise ValueError(f"gather_blend shapes: table {tuple(table.shape)} main {tuple(idx_main.shape)} "
                         f"sub {tuple(idx_sub.shape)} lam {tuple(lam.shape)}")
    if table.device.type == "cpu":
        return gather_blend_plain(table, idx_main, idx_sub, lam)
    _same_cuda_device("gather_blend", table, idx_main, idx_sub, lam)
    if table.dtype not in _DTYPE_CODE or not table.is_contiguous():
        raise ValueError(f"the gather_blend kernel takes a contiguous f32 or bf16 table, got {table.dtype}")
    L = table.shape[1]
    n = idx_main.shape[0]
    out = torch.empty((n, L), dtype=table.dtype, device=table.device)
    if n == 0 or L == 0:
        return out
    im, isub = (t.to(torch.int32).contiguous() for t in (idx_main, idx_sub))
    lam = lam.to(torch.float32).contiguous()
    # 16-byte vectors when every row starts on a 16-byte boundary (`out` is)
    vec = int(L * table.element_size() % 16 == 0 and table.data_ptr() % 16 == 0)
    with torch.cuda.device(table.device):
        err = _launcher("gather_blend")(
            table.data_ptr(), im.data_ptr(), isub.data_ptr(), lam.data_ptr(), out.data_ptr(),
            n, table.shape[0], L, _DTYPE_CODE[table.dtype] + 2 * vec, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "gather_blend")
    gather_blend.launches += 1
    return out


gather_blend.launches = 0


def place_notes(blend: torch.Tensor, slot: torch.Tensor, onset: torch.Tensor, gain: torch.Tensor,
                chunk_samples: int) -> torch.Tensor:
    """(B, S, L) blend rows (f32 or bf16, the stream dtype), (B, N) slots,
    onsets and gains -> (B, chunk_samples) f32 audio, through K3."""
    if blend.dim() != 3 or slot.dim() != 2 or slot.shape != onset.shape or slot.shape != gain.shape \
            or slot.shape[0] != blend.shape[0] or blend.shape[1] == 0 or chunk_samples < 1 or blend.shape[0] > 65535:
        raise ValueError(f"place_notes shapes: blend {tuple(blend.shape)} slot {tuple(slot.shape)} "
                         f"onset {tuple(onset.shape)} gain {tuple(gain.shape)} chunk {chunk_samples}")
    if blend.device.type == "cpu":
        return place_notes_plain(blend, slot, onset, gain, chunk_samples)
    _same_cuda_device("place_notes", blend, slot, onset, gain)
    if blend.dtype not in _DTYPE_CODE or not blend.is_contiguous():
        raise ValueError(f"the place_notes kernel takes contiguous f32 or bf16 blend rows, got {blend.dtype}")
    B, S, L = blend.shape
    n_notes = slot.shape[1]
    out = torch.empty((B, chunk_samples), dtype=torch.float32, device=blend.device)
    if B == 0:
        return out
    slot, onset = (t.to(torch.int32).contiguous() for t in (slot, onset))
    gain = gain.to(torch.float32).contiguous()
    with torch.cuda.device(blend.device):
        err = _launcher("place_notes")(
            blend.data_ptr(), slot.data_ptr(), onset.data_ptr(), gain.data_ptr(), out.data_ptr(),
            B, S, L, n_notes, chunk_samples, _DTYPE_CODE[blend.dtype], torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "place_notes")
    place_notes.launches += 1
    return out


place_notes.launches = 0
