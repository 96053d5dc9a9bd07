"""K5 forward: fused attention kernel (`csrc/attention.cu`) and its plain version.

Replaces `adt_str_tpu/ops/pallas_attention.py:_fwd` (the forward of
`fused_attention`). Both versions compute `_fwd`'s outputs for (B, H, T, D)
q, k, v and an optional additive (B, Tq, Tk) mask shared over heads:

    s = (q k^T) * (1/sqrt(D)) + mask     in fp32 (q, k upcast)
    out = (softmax(s) cast to v's dtype) . v     with fp32 accumulation
    lse = logsumexp(s)                   as (B, H, 1, Tq) fp32

Unlike the TPU kernel, neither version needs T padded to 8 (the JAX caller
pads the keys with -1e4, which adds exactly 0 to the softmax unless every
real key of a row is masked too). `fused_attention` is the wrapper: the CUDA
kernel for CUDA tensors (bf16, head dim 128, Tk <= 256), the plain version
for CPU tensors, and nothing else. `fused_attention.launches` counts kernel
launches. The backward (K5b) comes with the training slice.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from adt_str_tpu_torch.ops import _build

HEAD_DIM = 128  # `D` in csrc/attention.cu
MAX_KEYS = 256  # `MAX_TK` in csrc/attention.cu: the score tile must fit in shared memory


def attention_plain(q, k, v, mask=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K5 forward on the inputs' device -> (out, lse). The
    bf16 operands are multiplied as fp32 (`torch.matmul` of two bf16 CPU
    tensors would round its output to bf16)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        s = s + mask.float()[:, None]
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(denom)).transpose(-1, -2)  # (B, H, 1, Tq)
    p = (e / denom).to(v.dtype)
    out = torch.matmul(p.float(), v.float()).to(q.dtype)
    return out, lse


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.launch_attention_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, ctypes.c_float, p]
    lib.launch_attention_fwd.restype = ctypes.c_int
    if lib.attention_head_dim() != HEAD_DIM or lib.attention_max_keys() != MAX_KEYS:
        raise RuntimeError("csrc/attention.cu limits differ from cuda_attention's")
    return lib


def fused_attention(q, k, v, mask=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, Tq, D) x (B, H, Tk, D) attention -> (out, lse) through K5: the
    CUDA kernel for CUDA tensors, `attention_plain` for CPU tensors."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if k.shape != (B, H, Tk, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if mask is not None and mask.shape != (B, Tq, Tk):
        raise ValueError(f"mask must be (B, Tq, Tk) = {(B, Tq, Tk)}, got {tuple(mask.shape)}")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cpu or cuda tensors, not {q.device}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)) or D != HEAD_DIM or not 0 < Tk <= MAX_KEYS:
        raise ValueError(
            f"the attention kernel takes bf16 q, k, v with head dim {HEAD_DIM} and "
            f"1..{MAX_KEYS} keys; got {q.dtype}, D={D}, Tk={Tk}"
        )
    lib = _lib()
    q, k, v = (t.contiguous() for t in (q, k, v))
    if mask is not None:
        mask = mask.to(device=q.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, 1, Tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.launch_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B, H, Tq, Tk, 1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "attention_fwd")
    fused_attention.launches += 1
    return out, lse


fused_attention.launches = 0
