"""K4's plain version (`ops/ffn.py`, through `cuda_ffn.FusedFfnDropout`)
against the JAX package's fused FFN + dropout kernel in interpret mode, on
the CPU: forward values and zero pattern, `pre`, every gradient, the bf16
path and the layer gate. Cases follow `tests/test_pallas_ffn.py`.

Inputs are made by JAX from a seed (params, x and the two dropout keys) and
handed to the port as numpy arrays and key words.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adt_str_tpu.models import transformer as JT
from adt_str_tpu.ops import pallas_ffn
from adt_str_tpu_torch.models import transformer as TT
from adt_str_tpu_torch.ops import cuda_ffn
from adt_str_tpu_torch.ops.dropout_hash import seed_from_key

D = 384  # % 128 == 0, as the kernel gate needs
B, T_LEN = 2, 57  # N = 114: not a multiple of the Pallas row tile
RATE = 0.35

# Tolerances (as tests/test_pallas_ffn.py): fp32 forward 2e-5, gradients
# 1e-4 (the Pallas kernel and the port sum in other orders; the backward uses
# the exact erf against the forward's A-S erf on both sides). bf16: the same
# bf16 rounding points on both sides; an fp32 order difference can flip one
# rounding of pre or hd, which moves an output by ~1 bf16 ulp (2^-7 of its
# size at most), so outputs agree within 2^-6 of their largest magnitude.


def _setup(dtype=jnp.float32):
    kp, kx, kh, ko = jax.random.split(jax.random.PRNGKey(7), 4)
    p = JT.ffn_init(kp, D, 4 * D)
    x = jax.random.normal(kx, (B, T_LEN, D), jnp.float32).astype(dtype)
    return p, x, kh, ko


def _words(key):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)).reshape(-1))


def _port_layer(p):
    layer = torch.nn.Module()
    layer.linear1, layer.linear2 = torch.nn.Linear(D, 4 * D), torch.nn.Linear(4 * D, D)
    with torch.no_grad():
        for name in ("linear1", "linear2"):
            getattr(layer, name).weight.copy_(torch.from_numpy(np.asarray(p[name]["w"]).T.copy()))
            getattr(layer, name).bias.copy_(torch.from_numpy(np.array(p[name]["b"])))
    return layer


def _port(p, x, kh, ko, dtype=torch.float32):
    layer = _port_layer(p)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(dtype).requires_grad_()
    return layer, tx, TT.ffn_dropout_block(layer, tx, RATE, _words(kh), _words(ko))


def test_plain_k4_forward_matches_pallas_interpret():
    p, x, kh, ko = _setup()
    ref = np.asarray(JT.ffn_dropout_block(p, x, RATE, kh, ko, interpret=True))
    _, _, out = _port(p, x, kh, ko)
    out = out.detach().numpy()
    np.testing.assert_array_equal(out == 0.0, ref == 0.0)
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


def test_plain_k4_pre_matches_pallas_interpret():
    """The saved pre-activation (`_fwd_call`'s second output)."""
    p, x, kh, ko = _setup()
    seeds = jnp.concatenate([JT._seed_from_key(kh), JT._seed_from_key(ko)]).reshape(1, 4)
    x2 = x.reshape(B * T_LEN, D)
    _, ref_pre, _ = pallas_ffn._fwd_call(p["linear1"]["w"], p["linear1"]["b"], p["linear2"]["w"], p["linear2"]["b"],
                                         x2, seeds, 1 - RATE, 1 - RATE, True)
    w = {k: torch.from_numpy(np.array(p[k]["w"])) for k in ("linear1", "linear2")}
    b = {k: torch.from_numpy(np.array(p[k]["b"])) for k in ("linear1", "linear2")}
    tseeds = seed_from_key(_words(kh)) + seed_from_key(_words(ko))
    _, pre = cuda_ffn.ffn_dropout(torch.from_numpy(np.array(x2)), w["linear1"].T.contiguous(), b["linear1"],
                                  w["linear2"].T.contiguous(), b["linear2"], tseeds, 1 - RATE, 1 - RATE)
    np.testing.assert_allclose(pre.numpy(), np.asarray(ref_pre)[: B * T_LEN], rtol=2e-5, atol=2e-5)


def test_plain_k4_grads_match_pallas_interpret():
    p, x, kh, ko = _setup()

    def loss(p, x):
        return jnp.sum(jnp.sin(JT.ffn_dropout_block(p, x, RATE, kh, ko, interpret=True)))

    gp, gx = jax.grad(loss, argnums=(0, 1))(p, x)
    layer, tx, out = _port(p, x, kh, ko)
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-4)
    for name in ("linear1", "linear2"):
        mod = getattr(layer, name)
        np.testing.assert_allclose(mod.weight.grad.numpy().T, np.asarray(gp[name]["w"]), rtol=1e-4, atol=1e-4,
                                   err_msg=f"{name}/w")
        np.testing.assert_allclose(mod.bias.grad.numpy(), np.asarray(gp[name]["b"]), rtol=1e-4, atol=1e-4,
                                   err_msg=f"{name}/b")


def test_plain_k4_bf16_close_to_pallas_interpret():
    p, x, kh, ko = _setup(jnp.bfloat16)
    ref = np.asarray(JT.ffn_dropout_block(p, x, RATE, kh, ko, interpret=True).astype(jnp.float32))
    _, _, out = _port(p, x, kh, ko, torch.bfloat16)
    out = out.detach().float().numpy()
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out == 0.0, ref == 0.0)
    np.testing.assert_allclose(out, ref, atol=2**-6 * np.abs(ref).max(), rtol=0)


def test_fused_ffn_layer_gate_matches_jax():
    """The cases of `test_fused_ffn_layer_gate`, on both packages."""
    p, x, kh, ko = _setup()
    tx, wh = torch.from_numpy(np.array(x)), _words(kh)
    cases = [(x, tx, True, RATE, kh, wh), (x, tx, False, RATE, kh, wh), (x, tx, True, 0.0, kh, wh),
             (x, tx, True, RATE, None, None), (x[..., : D // 2], tx[..., : D // 2], True, RATE, kh, wh)]
    got = [TT._fused_ffn_ok(t, train, rate, w) for _, t, train, rate, _, w in cases]
    assert got == [JT._fused_ffn_ok(j, train, rate, k) for j, _, train, rate, k, _ in cases]
    assert got == [True, False, False, False, False]


def test_k4_wrapper_runs_plain_for_cpu_tensors():
    p, x, kh, ko = _setup()
    before = cuda_ffn.ffn_dropout.launches
    _port(p, x, kh, ko)
    assert cuda_ffn.ffn_dropout.launches == before
    with pytest.raises(ValueError, match="shapes"):
        cuda_ffn.ffn_dropout(torch.zeros(4, 8), torch.zeros(16, 8), torch.zeros(16), torch.zeros(16, 9),
                             torch.zeros(8), (1, 2, 3, 4), 0.9, 0.9)
