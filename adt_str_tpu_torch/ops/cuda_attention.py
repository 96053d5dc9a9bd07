"""K5: fused attention kernels (`csrc/attention.cu`, `csrc/attention_bwd.cu`,
`csrc/attention_wide.cu`, `csrc/attention_tf32.cu`) and their plain versions.

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
kernels for CUDA tensors, the plain versions for CPU tensors, and nothing
else. On the card they take what JAX's gate sends its kernel (head dim a
multiple of 128, any compute dtype): any Tq, Tk >= 1 in bf16, fp16 or fp32
at every head dim that is a multiple of 128, with no upper limit
(`kernel_for`):

    dtype        head dim     kernels (wrappers)
    bf16, fp16   128          attention.cu, attention_bwd.cu (fused_attention, fused_attention_bwd)
    bf16, fp16   256          the same sources at D 256 (fused_attention_d256, fused_attention_bwd_d256)
    bf16, fp16   384, 512...  attention_wide.cu (fused_attention_wide, fused_attention_bwd_wide)
    fp32         128, 256...  attention_tf32.cu (fused_attention_tf32, fused_attention_bwd_tf32)

`FusedAttention` is the autograd Function around the two (the mask gets no
gradient, as in JAX). Each wrapper's `launches` counts the launches of its
own kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from adt_str_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
NEG_MASK = -1e4  # the score of a virtual (padded) key
CHECKED_HEAD_DIMS = range(64, 4097, 64)  # where a library's `*_takes` is held to `kernel_for` when it loads


def kernel_for(dtype: torch.dtype, head_dim: int) -> str:
    """The K5 kernels that take q, k, v of `dtype` and `head_dim` on the
    card, at any Tq, Tk >= 1: "hopper" (bf16 or fp16 at head dim 128: TMA +
    wgmma), "hopper256" (bf16 or fp16 at 256: the same design at D 256),
    "wide" (bf16 or fp16 at 384 and past: TMA + wgmma, the head dim streamed)
    or "tf32x3" (fp32 at every head dim: mma.sync in 3xTF32). Raises a ValueError on
    any other dtype and on a head dim that is not a multiple of 128 (JAX's
    gate sends none)."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"the attention kernels take bf16, fp16 or fp32 q, k, v; got {dtype}")
    if head_dim % 128 or head_dim < 128:
        raise ValueError(f"the attention kernels take head dims that are multiples of 128; got D={head_dim}")
    if dtype == torch.float32:
        return "tf32x3"
    return {128: "hopper", 256: "hopper256"}.get(head_dim, "wide")


def routed(route: str) -> frozenset:
    """The (dtype, head dim) pairs of `CHECKED_HEAD_DIMS` that `kernel_for`
    sends to `route` ("hopper" and "hopper256" together: one source)."""
    names = ("hopper", "hopper256") if route.startswith("hopper") else (route,)
    return frozenset((t, d) for t in _DTYPE_CODE for d in CHECKED_HEAD_DIMS if d % 128 == 0
                     and kernel_for(t, d) in names)


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


def attention_fp64_rounded_scores(q, k, v, mask=None, n_virtual: int = 0) -> torch.Tensor:
    """K5's out in fp64 from the exact scores, each rounded once to fp32:
    q k^T / sqrt(D) + mask formed in fp64, rounded to fp32 (what an fp32
    product at fp32's accuracy gives), then the softmax with the virtual
    keys and the product with v in fp64. Where a row's real keys are all
    masked, its scores lie on fp32's 2^-10 grid near -1e4, and an fp32
    product that puts one across a rounding boundary moves out by ~2e-5: there
    this, not `attention_plain`, is the reference an fp32 kernel is held to."""
    s = ((q.double() @ k.double().transpose(-1, -2)) / math.sqrt(q.shape[-1])
         + (0.0 if mask is None else mask.double()[:, None])).float().double()
    m = s.amax(-1, keepdim=True).clamp(min=NEG_MASK)
    e = torch.exp(s - m)
    return (e / (e.sum(-1, keepdim=True) + n_virtual * torch.exp(NEG_MASK - m))) @ v.double()


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


def _takes(lib_takes) -> frozenset:
    """The (dtype, head dim) pairs of `CHECKED_HEAD_DIMS` a library's `*_takes(code, D)` accepts."""
    return frozenset((t, d) for t, code in _DTYPE_CODE.items() for d in CHECKED_HEAD_DIMS if lib_takes(code, d))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.launch_attention_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
    lib.launch_attention_fwd.restype = ctypes.c_int
    lib.attention_takes.argtypes = [i, i]
    lib.attention_takes.restype = ctypes.c_int
    if _takes(lib.attention_takes) != routed("hopper"):
        raise RuntimeError("csrc/attention.cu takes other dtypes or head dims than cuda_attention's")
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("attention_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.launch_attention_bwd.argtypes = [p] * 13 + [i] * 6 + [ctypes.c_float, p]
    lib.launch_attention_bwd.restype = ctypes.c_int
    lib.attention_bwd_takes.argtypes = [i, i]
    lib.attention_bwd_key_tile.argtypes = [i]
    lib.attention_bwd_takes.restype = lib.attention_bwd_key_tile.restype = ctypes.c_int
    if _takes(lib.attention_bwd_takes) != routed("hopper") or any(
            lib.attention_bwd_key_tile(d) != bwd_key_tile(d) for d in (128, 256)):
        raise RuntimeError("csrc/attention_bwd.cu limits differ from cuda_attention's")
    return lib


def bwd_key_tile(head_dim: int) -> int:
    """Keys of the tensor-core backward's key tile (csrc/attention_bwd.cu's
    `Shape<D>::BK`, csrc/attention_wide.cu's `BK`): past one tile dq is
    summed in an fp32 scratch."""
    return 64 if head_dim == 256 else 128


@functools.cache
def _tf32_lib() -> ctypes.CDLL:
    lib = _build.load("attention_tf32")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.launch_attention_tf32_fwd.argtypes = [p] * 6 + [i] * 7 + [f, p]
    lib.launch_attention_tf32_fwd.restype = ctypes.c_int
    lib.launch_attention_tf32_bwd.argtypes = [p] * 11 + [i] * 6 + [f, p]
    lib.launch_attention_tf32_bwd.restype = ctypes.c_int
    lib.attention_tf32_takes.argtypes = [i, i]
    lib.attention_tf32_takes.restype = ctypes.c_int
    if _takes(lib.attention_tf32_takes) != routed("tf32x3"):
        raise RuntimeError("csrc/attention_tf32.cu takes other dtypes or head dims than cuda_attention's")
    return lib


@functools.cache
def _wide_lib() -> ctypes.CDLL:
    lib = _build.load("attention_wide")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.launch_attention_wide_fwd.argtypes = [p] * 6 + [i] * 7 + [f, p]
    lib.launch_attention_wide_fwd.restype = ctypes.c_int
    lib.launch_attention_wide_bwd.argtypes = [p] * 13 + [i] * 6 + [f, p]
    lib.launch_attention_wide_bwd.restype = ctypes.c_int
    lib.attention_wide_takes.argtypes = [i, i]
    lib.attention_wide_takes.restype = lib.attention_wide_key_tile.restype = ctypes.c_int
    if _takes(lib.attention_wide_takes) != routed("wide") or lib.attention_wide_key_tile() != bwd_key_tile(384):
        raise RuntimeError("csrc/attention_wide.cu takes other dtypes, head dims or key tiles than cuda_attention's")
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
    if q.device.type == "cuda":
        if k.dtype != q.dtype or v.dtype != q.dtype or Tq < 1 or Tk < 1:
            raise ValueError(f"the attention kernels take q, k, v of one dtype and Tq, Tk >= 1; got "
                             f"{q.dtype}, {k.dtype}, {v.dtype}, Tq={Tq}, Tk={Tk}")
        kernel_for(q.dtype, D)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused attention runs on cpu or cuda tensors, not {q.device}")
    return B, H, Tq, Tk, D


def _mask_arg(mask, device):
    return None if mask is None else mask.to(device=device, dtype=torch.float32).contiguous()


def _launch_fwd(entry, what: str, q, k, v, mask, n_virtual: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A K5f entry point (`launch_attention*_fwd`: every source takes the
    same arguments) at q's dtype and head dim -> (out, lse)."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    q, k, v = (t.contiguous() for t in (q, k, v))
    mask = _mask_arg(mask, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, 1, Tq), dtype=torch.float32, device=q.device)
    err = _build.launch(
        q.device, entry, q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), lse.data_ptr(), _DTYPE_CODE[q.dtype], D, B, H, Tq, Tk, n_virtual, 1.0 / math.sqrt(D))
    _build.check(err, what)
    return out, lse


def fused_attention(q, k, v, mask=None, n_virtual: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, Tq, D) x (B, H, Tk, D) attention -> (out, lse) through K5f: the
    CUDA kernel that `kernel_for` names for CUDA tensors (this wrapper counts
    the head-dim-128 tensor-core kernel's launches; the others count on
    their own wrappers), `attention_plain` for CPU tensors."""
    B, H, Tq, Tk, D = _check(q, k, v, mask, n_virtual)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask, n_virtual)
    route = kernel_for(q.dtype, D)
    if route == "tf32x3":
        return fused_attention_tf32(q, k, v, mask, n_virtual)
    if route == "hopper256":
        return fused_attention_d256(q, k, v, mask, n_virtual)
    if route == "wide":
        return fused_attention_wide(q, k, v, mask, n_virtual)
    out, lse = _launch_fwd(_lib().launch_attention_fwd, "attention_fwd", q, k, v, mask, n_virtual)
    fused_attention.launches += 1
    return out, lse


fused_attention.launches = 0


def fused_attention_d256(q, k, v, mask=None, n_virtual: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """K5f on the tensor cores at head dim 256 (`csrc/attention.cu` at D
    256, bf16 or fp16; `fused_attention` sends those inputs here);
    `attention_plain` for CPU tensors."""
    B, H, Tq, Tk, D = _check(q, k, v, mask, n_virtual)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask, n_virtual)
    if kernel_for(q.dtype, D) != "hopper256":
        raise ValueError(f"the head-dim-256 attention kernels do not take {q.dtype} at D={D}")
    out, lse = _launch_fwd(_lib().launch_attention_fwd, "attention_fwd", q, k, v, mask, n_virtual)
    fused_attention_d256.launches += 1
    return out, lse


fused_attention_d256.launches = 0


def fused_attention_tf32(q, k, v, mask=None, n_virtual: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """K5f in fp32 on the tensor cores (`csrc/attention_tf32.cu`: every
    product in 3xTF32 on mma.sync, fp32 at every head dim; `fused_attention`
    sends those inputs here); `attention_plain` for CPU tensors."""
    B, H, Tq, Tk, D = _check(q, k, v, mask, n_virtual)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask, n_virtual)
    if kernel_for(q.dtype, D) != "tf32x3":
        raise ValueError(f"the 3xTF32 attention kernels do not take {q.dtype} at D={D}")
    out, lse = _launch_fwd(_tf32_lib().launch_attention_tf32_fwd, "attention_tf32_fwd", q, k, v, mask, n_virtual)
    fused_attention_tf32.launches += 1
    return out, lse


fused_attention_tf32.launches = 0


def fused_attention_wide(q, k, v, mask=None, n_virtual: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """K5f on the tensor cores past head dim 256 (`csrc/attention_wide.cu`:
    bf16 or fp16, the head dim streamed 64 columns a stage, out formed 128
    columns at a time; `fused_attention` sends those inputs here);
    `attention_plain` for CPU tensors."""
    B, H, Tq, Tk, D = _check(q, k, v, mask, n_virtual)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask, n_virtual)
    if kernel_for(q.dtype, D) != "wide":
        raise ValueError(f"the wide-head attention kernels do not take {q.dtype} at D={D}")
    out, lse = _launch_fwd(_wide_lib().launch_attention_wide_fwd, "attention_wide_fwd", q, k, v, mask, n_virtual)
    fused_attention_wide.launches += 1
    return out, lse


fused_attention_wide.launches = 0


def _check_bwd(q, k, v, mask, out, lse, do) -> tuple[int, int, int, int, int]:
    B, H, Tq, Tk, D = _check(q, k, v, mask, 0)
    if out.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, 1, Tq):
        raise ValueError(f"out/do must be {tuple(q.shape)} and lse {(B, H, 1, Tq)}")
    if q.device.type == "cuda" and (out.dtype != q.dtype or do.dtype != q.dtype or lse.dtype != torch.float32):
        raise ValueError(f"the backward kernels take out and do in q's dtype and fp32 lse; got {q.dtype}, "
                         f"{out.dtype}, {do.dtype}, {lse.dtype}")
    return B, H, Tq, Tk, D


def _tensor_core_bwd(entry, what: str, q, k, v, mask, out, lse, do) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A tensor-core K5b entry point (`launch_attention_bwd`,
    `launch_attention_wide_bwd`: the same arguments) at q's dtype and head
    dim, with its delta, dq and fp16 bound scratch."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    q, k, v, out, do, lse = (t.contiguous() for t in (q, k, v, out, do, lse))
    mask = _mask_arg(mask, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    dq_acc = torch.empty((B, H, Tq, D), dtype=torch.float32, device=q.device) if Tk > bwd_key_tile(D) else None
    # fp16: the largest do, out and v row norms of each (batch, head), which scale ds into fp16's range
    bound = torch.zeros((B * H, 3), dtype=torch.float32, device=q.device) if q.dtype == torch.float16 else None
    err = _build.launch(
        q.device, entry, q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), lse.data_ptr(), do.data_ptr(), delta.data_ptr(), None if dq_acc is None else dq_acc.data_ptr(),
        None if bound is None else bound.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _DTYPE_CODE[q.dtype], D, B, H, Tq, Tk, 1.0 / math.sqrt(D))
    _build.check(err, what)
    return dq, dk, dv


def fused_attention_bwd(q, k, v, mask, out, lse, do) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5b: (dq, dk, dv) of `fused_attention` for the output cotangent `do`,
    through the CUDA kernels that `kernel_for` names for CUDA tensors (this
    wrapper counts the head-dim-128 tensor-core kernel's launches) and
    `attention_bwd_plain` for CPU tensors. Deterministic: two calls on the
    same inputs give the same bits (dq's partial sums over key tiles meet
    in a fixed order in an fp32 scratch)."""
    B, H, Tq, Tk, D = _check_bwd(q, k, v, mask, out, lse, do)
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, mask, out, lse, do)
    route = kernel_for(q.dtype, D)
    if route == "tf32x3":
        return fused_attention_bwd_tf32(q, k, v, mask, out, lse, do)
    if route == "hopper256":
        return fused_attention_bwd_d256(q, k, v, mask, out, lse, do)
    if route == "wide":
        return fused_attention_bwd_wide(q, k, v, mask, out, lse, do)
    grads = _tensor_core_bwd(_bwd_lib().launch_attention_bwd, "attention_bwd", q, k, v, mask, out, lse, do)
    fused_attention_bwd.launches += 1
    return grads


fused_attention_bwd.launches = 0


def fused_attention_bwd_d256(q, k, v, mask, out, lse, do) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5b on the tensor cores at head dim 256 (`csrc/attention_bwd.cu` at
    D 256: the two consumer warpgroups split the head dim);
    `attention_bwd_plain` for CPU tensors."""
    B, H, Tq, Tk, D = _check_bwd(q, k, v, mask, out, lse, do)
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, mask, out, lse, do)
    if kernel_for(q.dtype, D) != "hopper256":
        raise ValueError(f"the head-dim-256 attention backward does not take {q.dtype} at D={D}")
    grads = _tensor_core_bwd(_bwd_lib().launch_attention_bwd, "attention_bwd", q, k, v, mask, out, lse, do)
    fused_attention_bwd_d256.launches += 1
    return grads


fused_attention_bwd_d256.launches = 0


def fused_attention_bwd_tf32(q, k, v, mask, out, lse, do) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5b in fp32 on the tensor cores (`csrc/attention_tf32.cu`: the delta
    pass, a dk/dv kernel over key tiles and a dq kernel over query tiles, no
    atomics, every product in 3xTF32) for fp32 at every head dim;
    `attention_bwd_plain` for CPU tensors."""
    B, H, Tq, Tk, D = _check_bwd(q, k, v, mask, out, lse, do)
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, mask, out, lse, do)
    if kernel_for(q.dtype, D) != "tf32x3":
        raise ValueError(f"the 3xTF32 attention backward does not take {q.dtype} at D={D}")
    q, k, v, out, do, lse = (t.contiguous() for t in (q, k, v, out, do, lse))
    mask = _mask_arg(mask, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    err = _build.launch(
        q.device, _tf32_lib().launch_attention_tf32_bwd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(), lse.data_ptr(), do.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _DTYPE_CODE[q.dtype], D, B, H, Tq, Tk, 1.0 / math.sqrt(D))
    _build.check(err, "attention_tf32_bwd")
    fused_attention_bwd_tf32.launches += 1
    return dq, dk, dv


fused_attention_bwd_tf32.launches = 0


def fused_attention_bwd_wide(q, k, v, mask, out, lse, do) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5b on the tensor cores past head dim 256 (`csrc/attention_wide.cu`:
    the delta pass, then a block a (batch, head, 128-column chunk) that walks
    the key and query tiles; dq's partial sums over key tiles meet in a fixed
    order in an fp32 scratch, so two calls give the same bits);
    `attention_bwd_plain` for CPU tensors."""
    B, H, Tq, Tk, D = _check_bwd(q, k, v, mask, out, lse, do)
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, mask, out, lse, do)
    if kernel_for(q.dtype, D) != "wide":
        raise ValueError(f"the wide-head attention backward does not take {q.dtype} at D={D}")
    grads = _tensor_core_bwd(_wide_lib().launch_attention_wide_bwd, "attention_wide_bwd", q, k, v, mask, out, lse, do)
    fused_attention_bwd_wide.launches += 1
    return grads


fused_attention_bwd_wide.launches = 0


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
