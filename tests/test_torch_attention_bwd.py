"""K5's backward and the padded-key repair, on the CPU: gradients through the
port's `FusedAttention` (its plain backward) against `jax.vjp` of the JAX
package's fused attention (the Pallas kernel in interpret mode), and a
fully masked row through both packages' `_flash_attention`.

JAX's `_flash_attention` pads the keys to T = roundup8(max(Tq, Tk)) with
k = v = 0 and -1e4; the port counts those virtual keys without storing them
(`cuda_attention.virtual_keys`). Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adt_str_tpu.models import transformer as JT
from adt_str_tpu.ops import pallas_attention
from adt_str_tpu_torch.models import transformer as TT
from adt_str_tpu_torch.ops import cuda_attention

# Tolerances: fp32 on both sides, other summation orders: outputs 1e-5,
# gradients 1e-4 of each gradient's largest element. bf16: p is rounded to
# bf16 at the same point on both sides and the backward works in fp32 from
# bf16 inputs; a flipped rounding moves an output or gradient element by
# ~1 bf16 ulp, so they agree within 2^-6 of their largest magnitude.
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2**-6}
OUT_TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}


def _inputs(B, H, Tq, Tk, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(B, H, T, 128)).astype(np.float32) for T in (Tq, Tk, Tk, Tq)]  # q, k, v, dout
    return [jnp.asarray(a).astype(dtype) for a in arrs], [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


def _mask(B, Tq, Tk, kind, seed=0):
    """(B, 1, Tq, Tk) additive mask as the model builds it: causal, causal
    with ragged key padding, or a row whose real keys are all masked."""
    m = np.zeros((B, 1, Tq, Tk), np.float32)
    if kind in ("causal", "padded", "masked-row"):
        m += np.triu(np.full((Tq, Tk), -1e4, np.float32), k=1)
    if kind == "padded":
        lengths = np.random.default_rng(seed).integers(1, Tk + 1, size=B)
        m += np.where(np.arange(Tk)[None, :] >= lengths[:, None], -1e4, 0.0)[:, None, None, :]
    if kind == "masked-row":
        m[:, :, 3, :] = -1e4
    return m


def _assert_close(got, ref, tol, what):
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    np.testing.assert_allclose(got, ref, atol=tol * np.abs(ref).max(), rtol=0, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B, H, Tq, Tk, kind",
    [(2, 2, 32, 32, "causal"), (2, 1, 30, 46, None), (1, 1, 511, 246, None), (2, 1, 63, 63, "padded"),
     (1, 1, 40, 512, "causal"), (1, 2, 30, 30, "masked-row")],
    ids=["causal", "ragged", "cross-training", "padded", "max-keys", "masked-row"],
)
def test_grads_match_jax_vjp_of_the_interpret_kernel(dtype, B, H, Tq, Tk, kind):
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(B, H, Tq, Tk, dtype)
    mask = None if kind is None else _mask(B, Tq, Tk, kind)
    jmask = None if mask is None else jnp.asarray(mask)
    ref, vjp = jax.vjp(lambda q, k, v: JT._flash_attention(q, k, v, jmask), jq, jk, jv)
    ref_grads = vjp(jdo)
    tq, tk, tv = (t.requires_grad_() for t in (tq, tk, tv))
    out = TT._flash_attention(tq, tk, tv, None if mask is None else torch.from_numpy(mask))
    out.backward(tdo)
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=OUT_TOL[dtype], rtol=0)
    for name, t, r in zip(("dq", "dk", "dv"), (tq, tk, tv), ref_grads):
        assert t.grad.dtype == t.dtype
        _assert_close(t.grad, r, GRAD_TOL[dtype], name)


def test_plain_backward_matches_the_pallas_backward_directly():
    """`attention_bwd_plain` against `_vjp_bwd` on unpadded (T % 8 == 0)
    inputs, with the forward's own out and lse."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(2, 3, 24, 24, "float32", seed=3)
    mask = _mask(2, 24, 24, "causal")[:, 0]
    out, lse = pallas_attention._fwd(jq, jk, jv, jnp.asarray(mask), 1.0 / np.sqrt(128), True)
    ref = pallas_attention._vjp_bwd(True, (jq, jk, jv, jnp.asarray(mask), out, lse), jdo)
    got = cuda_attention.attention_bwd_plain(tq, tk, tv, torch.from_numpy(mask), torch.from_numpy(np.array(out)),
                                             torch.from_numpy(np.array(lse)), tdo)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref[:3]):
        _assert_close(g, r, GRAD_TOL["float32"], name)
    assert float(jnp.abs(ref[3]).max()) == 0.0  # the mask's cotangent is zero; the port gives it none


@pytest.mark.parametrize("Tq, Tk", [(30, 30), (511, 246), (10, 246)])
def test_fully_masked_row_matches_jax_flash_attention(Tq, Tk):
    """Every real key of row 3 is masked: JAX's softmax spreads over its
    padded keys too, and the port's virtual keys must reproduce that."""
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs(1, 2, Tq, Tk, "float32", seed=5)
    mask = _mask(1, Tq, Tk, "masked-row")
    assert cuda_attention.virtual_keys(Tq, Tk) > 0
    ref = np.asarray(JT._flash_attention(jq, jk, jv, jnp.asarray(mask)))
    out = TT._flash_attention(tq, tk, tv, torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    # without the virtual keys the masked row would differ
    plain, _ = cuda_attention.attention_plain(tq, tk, tv, torch.from_numpy(mask[:, 0]), n_virtual=0)
    assert np.abs(plain.numpy()[:, :, 3] - ref[:, :, 3]).max() > 1e-3


def test_virtual_keys_follow_the_jax_padding():
    assert [cuda_attention.virtual_keys(tq, tk) for tq, tk in [(246, 246), (511, 511), (511, 246), (1, 1), (10, 246)]] \
        == [2, 1, 266, 7, 2]


def test_k5b_wrapper_runs_plain_for_cpu_tensors():
    _, (q, k, v, do) = _inputs(1, 1, 8, 8, "bfloat16")
    out, lse = cuda_attention.fused_attention(q, k, v)
    before = cuda_attention.fused_attention_bwd.launches
    got = cuda_attention.fused_attention_bwd(q, k, v, None, out, lse, do)
    ref = cuda_attention.attention_bwd_plain(q, k, v, None, out, lse, do)
    assert cuda_attention.fused_attention_bwd.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    with pytest.raises(ValueError, match="lse"):
        cuda_attention.fused_attention_bwd(q, k, v, None, out, lse[..., :4], do)
