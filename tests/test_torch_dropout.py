"""The port's counter-hash dropout against the JAX package's, on the CPU:
`hash_mask`, `seed_from_key` and `dropout` (forward and its regenerating
backward) must be bit-exact, so that both packages train on the same masks.

Keys are made by JAX and their two `key_data` words handed to the port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adt_str_tpu.models import transformer as JT
from adt_str_tpu_torch.models import transformer as TT
from adt_str_tpu_torch.ops import dropout_hash as H


def _words(key) -> tuple[int, int]:
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)).reshape(-1))


@pytest.mark.parametrize(
    "words", [(0, 5), (2**32 - 1, 2**32 - 2), (0, 2**32 - 1), (2**31, 2**31 + 1), (123456789, 987654321)]
)
def test_seed_from_key_is_bit_exact(words):
    ref = np.asarray(JT._seed_from_key(jnp.asarray(np.array(words, np.uint32))))
    assert H.seed_from_key(words) == tuple(int(w) for w in ref)


def test_hash_mask_is_bit_exact_past_2_to_the_24():
    """More than 2**24 elements (flat indices past float32's exact integers)
    and seed words near 2**32, where an int64 product would overflow."""
    shape = (4097, 4096)
    seed = (2**32 - 3, 2**32 - 7)
    ref = np.asarray(JT._hash_mask(shape, jnp.asarray(np.array(seed, np.uint32)), 0.9))
    got = H.hash_mask(shape, seed, 0.9).numpy()
    assert got.shape == shape
    np.testing.assert_array_equal(got, ref)
    assert abs(got.mean() - 0.9) < 1e-3


@pytest.mark.parametrize("keep", [0.5, 0.9, 1.0 - 1e-12])
def test_hash_mask_thresholds_match(keep):
    seed = H.seed_from_key((7, 11))
    ref = np.asarray(JT._hash_mask((64, 257), jnp.asarray(np.array(seed, np.uint32)), keep))
    np.testing.assert_array_equal(H.hash_mask((64, 257), seed, keep).numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_and_its_gradient_are_bit_exact(dtype):
    """Forward values (1/keep rounded to the dtype first, as JAX's weakly
    typed constant is) and the backward's regenerated mask."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 40)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    key = jax.random.PRNGKey(42)
    jx = jnp.asarray(x).astype(dtype)
    ref, vjp = jax.vjp(lambda a: JT.dropout(a, 0.3, key, True), jx)
    (ref_dx,) = vjp(jnp.asarray(g).astype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    out = TT.dropout(tx, 0.3, _words(key), True)
    out.backward(torch.from_numpy(g).to(getattr(torch, dtype)))
    assert out.dtype == tx.dtype
    np.testing.assert_array_equal(out.detach().float().numpy(), np.asarray(ref.astype(jnp.float32)))
    np.testing.assert_array_equal(tx.grad.float().numpy(), np.asarray(ref_dx.astype(jnp.float32)))


def test_dropout_is_identity_outside_training():
    x = torch.randn(4, 8)
    assert TT.dropout(x, 0.3, (1, 2), False) is x
    assert TT.dropout(x, 0.0, (1, 2), True) is x
    assert TT.dropout(x, 0.3, None, True) is x
