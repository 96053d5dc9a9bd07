"""The plain versions of K2 (gather + mixup blend) and K3 (note placement)
against the JAX package's Pallas kernels in interpret mode, on the CPU.

The port's wrappers (`ops/cuda_place.py`) run the plain versions for CPU
tensors; the CUDA kernels are held bit-equal to them on the card
(`test_torch_cuda_kernels.py`). Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adt_str_tpu.synth.pallas_place import gather_blend, place_notes
from adt_str_tpu_torch.ops import cuda_place
from adt_str_tpu_torch.ops.place import gather_blend_plain, place_notes_plain


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# K2 at f32: both compute (1 - lam) * m + lam * s in f32. The port rounds
# each operation on its own (as its kernel does); the interpreter's XLA
# computes fma(1 - lam, m, lam * s), which saves the first product's
# rounding. The two differ by that rounding and the sum's, at most 2^-23 of
# |(1 - lam) m| + |lam s| (measured 1.9999 * 2^-24; up to 284 ulp of the
# result where the terms cancel); the bf16 case below is equal.
@pytest.mark.parametrize("n_rows, n_req, req_tile", [(37, 13, 8), (192, 64, 8), (50, 8, 16), (21, 6, 1)])
def test_gather_blend_plain_matches_pallas(n_rows, n_req, req_tile):
    rng = np.random.default_rng(n_rows + n_req)
    L = 256
    table = rng.normal(size=(n_rows, L)).astype(np.float32)
    im = rng.integers(0, n_rows, n_req).astype(np.int32)
    isub = rng.integers(0, n_rows, n_req).astype(np.int32)
    lam = rng.uniform(0, 0.8, n_req).astype(np.float32)
    ref = np.asarray(gather_blend(jnp.asarray(table), jnp.asarray(im), jnp.asarray(isub), jnp.asarray(lam),
                                  interpret=True, req_tile=req_tile))
    got = cuda_place.gather_blend(_t(table), _t(im), _t(isub), _t(lam))
    assert got.dtype == torch.float32 and got.shape == (n_req, L)
    terms = np.abs((1 - lam[:, None]) * table[im]) + np.abs(lam[:, None] * table[isub])
    assert (np.abs(got.numpy() - ref) <= 2.0**-23 * terms).all()


def test_gather_blend_plain_bf16_table_matches_pallas():
    """A bf16 bank: the blend is computed in f32 and rounded to bf16 once
    on both sides, so the two are equal."""
    rng = np.random.default_rng(5)
    table = rng.normal(size=(40, 384)).astype(np.float32)
    im, isub = rng.integers(0, 40, 17).astype(np.int32), rng.integers(0, 40, 17).astype(np.int32)
    lam = rng.uniform(0, 0.8, 17).astype(np.float32)
    jt = jnp.asarray(table, jnp.bfloat16)
    ref = np.asarray(gather_blend(jt, jnp.asarray(im), jnp.asarray(isub), jnp.asarray(lam), interpret=True)
                     .astype(jnp.float32))
    got = gather_blend_plain(_t(table).to(torch.bfloat16), _t(im), _t(isub), _t(lam))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref)


def _place_inputs(seed, B=2, S=4, L=256, N=11, C=1280):
    rng = np.random.default_rng(seed)
    blend = rng.normal(size=(B, S, L)).astype(np.float32)
    slot = rng.integers(0, S, (B, N)).astype(np.int32)
    onset = rng.integers(0, C, (B, N)).astype(np.int32)
    gain = rng.uniform(0.2, 1.0, (B, N)).astype(np.float32)
    gain[0, 3] = 0.0
    return blend, slot, onset, gain, C


def _pallas_place(blend, slot, onset, gain, C, stream=jnp.float32):
    return np.asarray(place_notes(jnp.asarray(blend), jnp.asarray(slot), jnp.asarray(onset), jnp.asarray(gain), C,
                                  interpret=True, stream_dtype=stream))


# K3: the same f32 products added in note order on both sides; the TPU
# kernel's rotations move no value. atol 1e-6 (measured: equal).
@pytest.mark.parametrize("seed", [0, 1])
def test_place_notes_plain_matches_pallas(seed):
    blend, slot, onset, gain, C = _place_inputs(seed)
    got = cuda_place.place_notes(_t(blend), _t(slot), _t(onset), _t(gain), C)
    assert got.dtype == torch.float32 and got.shape == (2, C)
    np.testing.assert_allclose(got.numpy(), _pallas_place(blend, slot, onset, gain, C), atol=1e-6, rtol=0)


def test_place_notes_plain_edges_match_pallas():
    """Onset 0, onset at the last sample (clipped to one sample), overlapping
    notes and a zero gain."""
    B, S, L, C = 1, 2, 128, 512
    blend = np.ones((B, S, L), np.float32)
    blend[0, 1] = np.linspace(-1, 1, L)
    slot = np.array([[0, 0, 0, 1, 1]], np.int32)
    onset = np.array([[0, C - 1, 64, 70, 3]], np.int32)
    gain = np.array([[1.0, 2.0, 0.5, 0.25, 0.0]], np.float32)
    got = place_notes_plain(_t(blend), _t(slot), _t(onset), _t(gain), C).numpy()
    np.testing.assert_allclose(got, _pallas_place(blend, slot, onset, gain, C), atol=1e-6, rtol=0)
    assert got[0, C - 1] == 2.0 and got[0, 0] == 1.0 and got[0, 64] == 1.5
    assert got[0, 70] == 1.5 + 0.25 * blend[0, 1, 0]


def test_place_notes_plain_empty_is_silent():
    got = place_notes_plain(torch.zeros(1, 2, 128), torch.zeros(1, 4, dtype=torch.int32),
                            torch.zeros(1, 4, dtype=torch.int32), torch.zeros(1, 4), 256)
    assert got.shape == (1, 256) and (got == 0).all()


def test_place_notes_plain_bf16_stream_matches_pallas():
    """bf16 blend rows (the stream on the card): both read the same bf16
    values and accumulate in f32."""
    blend, slot, onset, gain, C = _place_inputs(7)
    ref = _pallas_place(blend, slot, onset, gain, C, stream=jnp.bfloat16)
    got = place_notes_plain(_t(blend).to(torch.bfloat16), _t(slot), _t(onset), _t(gain), C).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    f32 = place_notes_plain(_t(blend), _t(slot), _t(onset), _t(gain), C).numpy()
    assert np.abs(got - f32).max() > 0  # really quantized


def test_wrappers_reject_bad_shapes_and_devices():
    with pytest.raises(ValueError, match="gather_blend shapes"):
        cuda_place.gather_blend(torch.zeros(4, 8), torch.zeros(3, dtype=torch.int32),
                                torch.zeros(2, dtype=torch.int32), torch.zeros(3))
    with pytest.raises(ValueError, match="place_notes shapes"):
        cuda_place.place_notes(torch.zeros(2, 3, 8), torch.zeros(2, 4), torch.zeros(2, 5), torch.zeros(2, 4), 16)
    with pytest.raises(ValueError, match="cpu or cuda"):
        cuda_place.gather_blend(torch.zeros(4, 8, device="meta"), torch.zeros(3, dtype=torch.int32, device="meta"),
                                torch.zeros(3, dtype=torch.int32, device="meta"), torch.zeros(3, device="meta"))


def test_wrappers_clamp_out_of_range_ids():
    """Row ids, slots and onsets outside their range are clamped into it (as
    JAX's gathers clamp), on the CPU as the kernels do on the card."""
    rng = np.random.default_rng(9)
    table = _t(rng.normal(size=(6, 64)).astype(np.float32))
    lam = _t(rng.uniform(0, 0.8, 4).astype(np.float32))
    got = cuda_place.gather_blend(table, torch.tensor([6, -1, 100, 2]), torch.tensor([-5, 9, 0, 5]), lam)
    ref = cuda_place.gather_blend(table, torch.tensor([5, 0, 5, 2]), torch.tensor([0, 5, 0, 5]), lam)
    assert torch.equal(got, ref)
    blend, slot, onset, gain, C = _place_inputs(3)
    slot[0, :3], onset[0, 3:6], onset[1, :2] = [4, 9, -2], [C, C + 500, -40], [-1, 2 * C]
    got = cuda_place.place_notes(_t(blend), _t(slot), _t(onset), _t(gain), C)
    ref = cuda_place.place_notes(_t(blend), _t(np.clip(slot, 0, 3)), _t(np.clip(onset, 0, C - 1)), _t(gain), C)
    assert torch.equal(got, ref) and got[0, C - 1] != 0
