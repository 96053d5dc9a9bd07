"""K5: fused attention kernels (`csrc/attention.cu`, `csrc/attention_bwd.cu`)
and their plain versions.

Replaces `adt_str_tpu/ops/pallas_attention.py:fused_attention`: the forward
`_fwd` (K5f) and the backward `_vjp_bwd` (K5b). For (B, H, T, D) q, k, v and
an optional additive (B, Tq, Tk) mask shared over heads:

    s = (q k^T) * (1/sqrt(D)) + mask     in fp32 (q, k upcast)
    out = (softmax(s) cast to v's dtype) . v     with fp32 accumulation
    lse = logsumexp(s)                   as (B, H, 1, Tq) fp32

and the backward, all in fp32 (JAX `_bwd_kernel`):

    p = exp(s - lse); dv = p^T do; dp = do v^T; delta = rowsum(do * out)
    ds = p (dp - delta) / sqrt(D); dq = ds k; dk = ds^T q

Virtual keys. The JAX caller (`transformer._flash_attention`) pads the keys
to T = max(roundup8(max(Tq, Tk)), 8) with k = v = 0 and an additive -1e4, so
each row has `n_virtual = T - Tk` extra keys that score exactly -1e4. They
add nothing to the softmax unless every real key of the row scores below
about -1e4 + 88 (a fully masked row), where they take their share. Both
versions here count them without materialising them: the row max is
`max(m_real, -1e4)`, the denominator gains `n_virtual * exp(-1e4 - m)`, and
lse includes them. The backward then needs nothing more: their dk and dv are
discarded by the caller and their dq term is multiplied by k = 0.

`fused_attention` and `fused_attention_bwd` are the wrappers: the CUDA
kernels for CUDA tensors (bf16, head dim 128, 1..512 keys), the
plain versions for CPU tensors, and nothing else. `FusedAttention` is the
autograd Function around the two (the mask gets no gradient, as in JAX).
Each wrapper's `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from adt_str_tpu_torch.ops import _build

HEAD_DIM = 128  # `D` in csrc/attention.cu and csrc/attention_bwd.cu
BWD_KEY_TILE = 128  # `BK` in csrc/attention_bwd.cu: past one key tile dq is summed in an fp32 scratch
MAX_KEYS = 512  # `MAX_TK` in csrc/attention.cu: the fp32 score rows of a block fit in shared memory
NEG_MASK = -1e4  # the score of a virtual (padded) key


def virtual_keys(tq: int, tk: int) -> int:
    """Keys the JAX caller pads on: max(roundup8(max(Tq, Tk)), 8) - Tk."""
    return max(-(-max(tq, tk) // 8) * 8, 8) - tk


def _scores(q, k, mask) -> torch.Tensor:
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if mask is not None:
        s = s + mask.float()[:, None]
    return s


def attention_plain(q, k, v, mask=None, n_virtual: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K5 forward on the inputs' device -> (out, lse). The
    bf16 operands are multiplied as fp32 (`torch.matmul` of two bf16 CPU
    tensors would round its output to bf16)."""
    s = _scores(q, k, mask)
    m = s.amax(dim=-1, keepdim=True)
    if n_virtual:
        m = torch.clamp(m, min=NEG_MASK)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    if n_virtual:
        denom = denom + n_virtual * torch.exp(NEG_MASK - m)
    lse = (m + torch.log(denom)).transpose(-1, -2)  # (B, H, 1, Tq)
    p = (e / denom).to(v.dtype)
    out = torch.matmul(p.float(), v.float()).to(q.dtype)
    return out, lse


def attention_bwd_plain(q, k, v, mask, out, lse, do) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch K5 backward -> (dq, dk, dv) in q's dtype, every product
    in fp32 as in the JAX `_bwd_kernel`; `lse` already counts the virtual keys."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.exp(_scores(q, k, mask) - lse.transpose(-1, -2))
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.launch_attention_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
    lib.launch_attention_fwd.restype = ctypes.c_int
    lib.attention_head_dim.restype = lib.attention_max_keys.restype = ctypes.c_int
    if lib.attention_head_dim() != HEAD_DIM or lib.attention_max_keys() != MAX_KEYS:
        raise RuntimeError("csrc/attention.cu limits differ from cuda_attention's")
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("attention_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.launch_attention_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, ctypes.c_float, p]
    lib.launch_attention_bwd.restype = ctypes.c_int
    lib.attention_bwd_head_dim.restype = lib.attention_bwd_key_tile.restype = ctypes.c_int
    if lib.attention_bwd_head_dim() != HEAD_DIM or lib.attention_bwd_key_tile() != BWD_KEY_TILE:
        raise RuntimeError("csrc/attention_bwd.cu limits differ from cuda_attention's")
    return lib


def _check(q, k, v, mask, n_virtual: int) -> tuple[int, int, int, int, int]:
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if k.shape != (B, H, Tk, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if mask is not None and mask.shape != (B, Tq, Tk):
        raise ValueError(f"mask must be (B, Tq, Tk) = {(B, Tq, Tk)}, got {tuple(mask.shape)}")
    if n_virtual < 0:
        raise ValueError(f"n_virtual must be >= 0, got {n_virtual}")
    if q.device.type == "cuda" and (
        any(t.dtype != torch.bfloat16 for t in (q, k, v)) or D != HEAD_DIM
        or not 0 < Tk <= MAX_KEYS or Tq < 1
    ):
        raise ValueError(
            f"the attention kernels take bf16 q, k, v with head dim {HEAD_DIM} and "
            f"1..{MAX_KEYS} keys; got {q.dtype}, D={D}, Tq={Tq}, Tk={Tk}"
        )
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused attention runs on cpu or cuda tensors, not {q.device}")
    return B, H, Tq, Tk, D


def _mask_arg(mask, device):
    return None if mask is None else mask.to(device=device, dtype=torch.float32).contiguous()


def fused_attention(q, k, v, mask=None, n_virtual: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, Tq, D) x (B, H, Tk, D) attention -> (out, lse) through K5f: the
    CUDA kernel for CUDA tensors, `attention_plain` for CPU tensors."""
    B, H, Tq, Tk, D = _check(q, k, v, mask, n_virtual)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask, n_virtual)
    lib = _lib()
    q, k, v = (t.contiguous() for t in (q, k, v))
    mask = _mask_arg(mask, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, 1, Tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.launch_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B, H, Tq, Tk, n_virtual, 1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "attention_fwd")
    fused_attention.launches += 1
    return out, lse


fused_attention.launches = 0


def fused_attention_bwd(q, k, v, mask, out, lse, do) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5b: (dq, dk, dv) of `fused_attention` for the output cotangent `do`,
    through the CUDA kernels for CUDA tensors and `attention_bwd_plain` for
    CPU tensors. Deterministic: two calls on the same inputs give the same
    bits (no atomics; dq's partial sums over key tiles meet in a fixed order
    in an fp32 scratch)."""
    B, H, Tq, Tk, D = _check(q, k, v, mask, 0)
    if out.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, 1, Tq):
        raise ValueError(f"out/do must be {tuple(q.shape)} and lse {(B, H, 1, Tq)}")
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, mask, out, lse, do)
    if out.dtype != torch.bfloat16 or do.dtype != torch.bfloat16 or lse.dtype != torch.float32:
        raise ValueError(f"the backward kernel takes bf16 out and do and fp32 lse; got {out.dtype}, {do.dtype}, {lse.dtype}")
    lib = _bwd_lib()
    q, k, v, out, do, lse = (t.contiguous() for t in (q, k, v, out, do, lse))
    mask = _mask_arg(mask, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    dq_acc = torch.empty((B, H, Tq, D), dtype=torch.float32, device=q.device) if Tk > BWD_KEY_TILE else None
    with torch.cuda.device(q.device):
        err = lib.launch_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(), do.data_ptr(), delta.data_ptr(),
            None if dq_acc is None else dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, H, Tq, Tk, 1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "attention_bwd")
    fused_attention_bwd.launches += 1
    return dq, dk, dv


fused_attention_bwd.launches = 0


class FusedAttention(torch.autograd.Function):
    """`fused_attention`'s output with K5b as its backward; the mask is a
    constant (no gradient), as the JAX custom VJP's zero mask cotangent."""

    @staticmethod
    def forward(ctx, q, k, v, mask, n_virtual: int):
        out, lse = fused_attention(q, k, v, mask, n_virtual)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = fused_attention_bwd(q, k, v, mask, out, lse, do)
        return dq, dk, dv, None, None
