"""The port's plain K5 forward against the JAX package's fused attention,
on the CPU (the Pallas kernel in interpret mode).

Inputs are made with numpy from a seed and fed to both sides.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adt_str_tpu.models import transformer as JT
from adt_str_tpu.ops import pallas_attention
from adt_str_tpu_torch.models import transformer as TT
from adt_str_tpu_torch.ops import cuda_attention

# Tolerances. fp32: the same fp32 arithmetic in another summation order.
# bf16: p is rounded to bf16 at the same point on both sides; an fp32 order
# difference can flip one rounding, which moves out by at most ~1 bf16 ulp
# of |out| < 4 (1.6e-2). lse is fp32 on both sides.
OUT_TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}


def _inputs(shapes, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    j = [jnp.asarray(a).astype(dtype) for a in arrs]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return j, t


def _causal(B, Tq, Tk):
    return np.broadcast_to(np.triu(np.full((Tq, Tk), -1e4, np.float32), k=1), (B, Tq, Tk)).copy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_plain_k5_matches_pallas_fwd(dtype, with_mask):
    B, H, T, D = 2, 3, 32, 128
    (jq, jk, jv), (tq, tk, tv) = _inputs([(B, H, T, D)] * 3, dtype)
    mask = _causal(B, T, T) if with_mask else None
    ref, ref_lse = pallas_attention._fwd(
        jq, jk, jv, None if mask is None else jnp.asarray(mask), 1.0 / np.sqrt(D), True
    )
    out, lse = cuda_attention.fused_attention(tq, tk, tv, None if mask is None else torch.from_numpy(mask))
    assert out.dtype == getattr(torch, dtype) and lse.shape == (B, H, 1, T)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=OUT_TOL[dtype], rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Tq, Tk, causal", [(30, 30, True), (30, 30, False), (10, 30, False)])
def test_ragged_t_matches_jax_padded_flash(dtype, Tq, Tk, causal):
    """T not a multiple of 8: JAX pads to 8 and masks the padded keys with
    -1e4 (`transformer._flash_attention`); the port takes ragged T as is."""
    B, H, D = 2, 2, 128
    (jq, jk, jv), (tq, tk, tv) = _inputs([(B, H, Tq, D), (B, H, Tk, D), (B, H, Tk, D)], dtype, seed=1)
    mask = _causal(1, Tq, Tk)[:, None] if causal else None  # (1, 1, Tq, Tk), as the model builds it
    ref = JT._flash_attention(jq, jk, jv, None if mask is None else jnp.asarray(mask))
    out = TT._flash_attention(tq, tk, tv, None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=OUT_TOL[dtype], rtol=0)


def test_k5_wrapper_runs_plain_for_cpu_tensors():
    _, (q, k, v) = _inputs([(1, 1, 8, 128)] * 3, "bfloat16")
    before = cuda_attention.fused_attention.launches
    out, lse = cuda_attention.fused_attention(q, k, v)
    ref, ref_lse = cuda_attention.attention_plain(q, k, v)
    assert cuda_attention.fused_attention.launches == before
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    with pytest.raises(ValueError, match="mask"):
        cuda_attention.fused_attention(q, k, v, torch.zeros(1, 8, 9))
