"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips without a CUDA device. On the machine with the
card run them with `python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda_kernels.py` (`--noconftest`: `tests/conftest.py`
imports JAX, which that machine does not have). This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from adt_str_tpu_torch.ops import cuda_attention, cuda_ffn, cuda_mel, cuda_place
from adt_str_tpu_torch.ops.dropout_hash import seed_from_key
from adt_str_tpu_torch.ops.ffn import ffn_dropout_plain
from adt_str_tpu_torch.ops.mel import MelFrontendParams
from adt_str_tpu_torch.ops.place import gather_blend_plain, place_notes_plain

pytestmark = pytest.mark.cuda

SERVING_MEL = MelFrontendParams(sample_rate=24000, win_length=2048, hop_length=240, n_mels=128)
SMALL_MEL = MelFrontendParams(sample_rate=8000, win_length=512, hop_length=80, n_mels=64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _wave(b, n, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=(b, n)) * 0.3).astype(np.float32))


# Tolerances: both sides multiply the same bf16-rounded frames and bases with
# fp32 accumulation and differ only in summation order, so the normalized
# output agrees to fp32 rounding (1e-4 on [0, 1]); in dB the same relative
# error reads ~1e-3 dB.
@pytest.mark.parametrize(
    "params, n, trim, tol",
    [
        (SERVING_MEL, 61440, True, 1e-4),
        (SMALL_MEL, 10240, False, 1e-4),
        (MelFrontendParams(sample_rate=8000, win_length=512, hop_length=80, n_mels=64, log_mode="db"),
         10240, True, 1e-3),
    ],
    ids=["serving", "small-untrimmed", "small-db"],
)
def test_log_mel_kernel_matches_plain(cuda, params, n, trim, tol):
    wave = _wave(3, n, seed=1).to(cuda)
    before = cuda_mel.log_mel.launches
    out = cuda_mel.log_mel(wave, params, trim)
    torch.cuda.synchronize()
    assert cuda_mel.log_mel.launches == before + 1
    ref = cuda_mel.log_mel_plain(wave, params, trim)
    assert out.shape == ref.shape
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= tol


def _assert_log_mel_matches_plain(wave, params, trim=True):
    before = cuda_mel.log_mel.launches
    out = cuda_mel.log_mel(wave, params, trim)
    torch.cuda.synchronize()
    assert cuda_mel.log_mel.launches == before + 1
    ref = cuda_mel.log_mel_plain(wave, params, trim)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= (1e-3 if params.log_mode == "db" else 1e-4)


@pytest.mark.parametrize("batch", [1, 16, 64])
def test_log_mel_kernel_batches(cuda, batch):
    """The serving and training batches: one frequency split per grid size
    (8 blocks share a frame tile at B 1, 4 at B 16, none at B 64)."""
    _assert_log_mel_matches_plain(_wave(batch, 61440, seed=batch).to(cuda), SERVING_MEL)


# The kernel's blocks hold 128 frames: kept frame counts below, at and past
# that tile, one frame, and the model's 246; hop 240 (the model) and 80.
@pytest.mark.parametrize("kept", [1, 127, 128, 129, 246])
@pytest.mark.parametrize(
    "params",
    [SERVING_MEL, SMALL_MEL,
     MelFrontendParams(sample_rate=8000, win_length=512, hop_length=80, n_mels=64, log_mode="db")],
    ids=["hop240", "hop80", "hop80-db"],
)
def test_log_mel_kernel_frame_tile_edges(cuda, params, kept):
    n = (kept + 2 * params.window_pad_idxs) * params.hop_length + params.hop_length // 2
    assert params.out_frames(n) == kept
    _assert_log_mel_matches_plain(_wave(2, n, seed=kept).to(cuda), params)


def test_log_mel_kernel_silence(cuda):
    out = cuda_mel.log_mel(torch.zeros(2, 61440, device=cuda), SERVING_MEL)
    assert out.abs().max().item() == 0.0


def _qkv(B, H, Tq, Tk, cuda, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return tuple(torch.randn(B, H, T, 128, generator=g).to(cuda, torch.bfloat16) for T in (Tq, Tk, Tk))


def _causal(B, Tq, Tk, cuda, masked_row=None):
    mask = torch.triu(torch.full((Tq, Tk), -1e4), diagonal=1).expand(B, Tq, Tk).clone()
    if masked_row is not None:
        mask[:, masked_row] = -1e4
    return mask.to(cuda)


# (B, H, Tq, Tk, mask): the serving and training shapes of the model (encoder
# 246, decoder self 511, cross 511 x 246), ragged and limit cases, and a row
# whose real keys are all masked (where the virtual keys take their share).
ATTENTION_CASES = {
    "encoder": (2, 6, 246, 246, None),
    "ragged-causal": (2, 1, 30, 30, "causal"),
    "cross": (1, 2, 10, 246, None),
    "decoder-self": (2, 6, 511, 511, "causal"),
    "cross-training": (2, 6, 511, 246, None),
    "max-keys": (1, 1, 256, 512, "causal"),
    "masked-row": (1, 2, 30, 30, "masked-row"),
}


def _attention_inputs(case, cuda):
    B, H, Tq, Tk, kind = ATTENTION_CASES[case]
    q, k, v = _qkv(B, H, Tq, Tk, cuda)
    mask = None if kind is None else _causal(B, Tq, Tk, cuda, 3 if kind == "masked-row" else None)
    return q, k, v, mask, cuda_attention.virtual_keys(Tq, Tk)


# Tolerances: scores and softmax agree to fp32 rounding; p is rounded to bf16
# on both sides and a rare ulp flip there moves out by ~1 bf16 ulp of |out|.
def _assert_attention_matches_plain(q, k, v, mask, n_virtual):
    before = cuda_attention.fused_attention.launches
    out, lse = cuda_attention.fused_attention(q, k, v, mask, n_virtual)
    torch.cuda.synchronize()
    assert cuda_attention.fused_attention.launches == before + 1
    ref, ref_lse = cuda_attention.attention_plain(q, k, v, mask, n_virtual)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape and lse.shape == ref_lse.shape
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    assert (out.float() - ref.float()).abs().max().item() <= 1.6e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-4


@pytest.mark.parametrize("case", list(ATTENTION_CASES))
def test_attention_kernel_matches_plain(cuda, case):
    _assert_attention_matches_plain(*_attention_inputs(case, cuda))


# The forward's tiles are 128 query rows and 64 keys: lengths below, at and
# past a tile's edge, one query or one key, at B = 1 (a causal mask where
# Tq == Tk).
EDGE_LENGTHS = (1, 30, 65, 246, 511)


@pytest.mark.parametrize("tk", EDGE_LENGTHS)
@pytest.mark.parametrize("tq", EDGE_LENGTHS)
def test_attention_kernel_tile_edges(cuda, tq, tk):
    q, k, v = _qkv(1, 2, tq, tk, cuda, seed=1000 * tq + tk)
    mask = _causal(1, tq, tk, cuda) if tq == tk else None
    _assert_attention_matches_plain(q, k, v, mask, cuda_attention.virtual_keys(tq, tk))


@pytest.mark.parametrize("tk", (65, 511))
def test_attention_kernel_row_whose_only_key_is_the_last(cuda, tk):
    """Row 7 sees only key Tk - 1 (in the last, ragged key tile); row 3
    sees none, and the virtual keys take their share."""
    q, k, v = _qkv(1, 2, 30, tk, cuda, seed=tk)
    mask = torch.zeros(1, 30, tk)
    mask[:, 7, : tk - 1] = -1e4
    mask[:, 3] = -1e4
    _assert_attention_matches_plain(q, k, v, mask.to(cuda), cuda_attention.virtual_keys(30, tk))


# Tolerance: the kernel rounds p and ds to bf16 (relative 2^-9) to enter the
# p^T do, ds^T q and ds k products, which the plain version takes in fp32,
# and both round their outputs to bf16 (relative 2^-8): within 2^-6 of the
# largest gradient of each output.
@pytest.mark.parametrize("case", list(ATTENTION_CASES))
def test_attention_bwd_kernel_matches_plain(cuda, case):
    q, k, v, mask, n_virtual = _attention_inputs(case, cuda)
    out, lse = cuda_attention.fused_attention(q, k, v, mask, n_virtual)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(cuda, torch.bfloat16)
    before = cuda_attention.fused_attention_bwd.launches
    grads = cuda_attention.fused_attention_bwd(q, k, v, mask, out, lse, do)
    torch.cuda.synchronize()
    assert cuda_attention.fused_attention_bwd.launches == before + 1
    refs = cuda_attention.attention_bwd_plain(q, k, v, mask, out, lse, do)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape, name
        assert torch.isfinite(got.float()).all(), name
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 2**-6 * ref.float().abs().max().item(), (name, err)


def _gradient_magnitudes(q, k, v, mask, out, lse, do):
    """The largest |dq|, |dk|, |dv| that the inputs' magnitudes allow: the
    gradients computed on absolute values (|dp| + |delta| in place of
    dp - delta). Where ds = p (dp - delta) cancels to nearly 0 (a row with a
    single real key), fp32 rounding of dp and delta leaves an error of that
    magnitude's order, not of the nearly vanishing gradient's."""
    scale = q.shape[-1] ** -0.5
    qa, ka, va, oa, da = (t.float().abs() for t in (q, k, v, out, do))
    p = torch.exp(cuda_attention._scores(q, k, mask) - lse.transpose(-1, -2))
    ds = p * (da @ va.transpose(-1, -2) + (da * oa).sum(-1, keepdim=True)) * scale
    return (ds @ ka).max().item(), (ds.transpose(-1, -2) @ qa).max().item(), (p.transpose(-1, -2) @ da).max().item()


def _assert_attention_bwd_matches_plain(q, k, v, mask, n_virtual):
    """Within 2^-6 of each gradient's largest element (as above), plus 2^-12
    of the magnitude its terms allow, for the rows where they cancel."""
    out, lse = cuda_attention.fused_attention(q, k, v, mask, n_virtual)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(2)).to(q.device, torch.bfloat16)
    grads = cuda_attention.fused_attention_bwd(q, k, v, mask, out, lse, do)
    torch.cuda.synchronize()
    refs = cuda_attention.attention_bwd_plain(q, k, v, mask, out, lse, do)
    sizes = _gradient_magnitudes(q, k, v, mask, out, lse, do)
    for name, got, ref, size in zip(("dq", "dk", "dv"), grads, refs, sizes):
        assert got.shape == ref.shape and torch.isfinite(got.float()).all(), name
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 2**-6 * ref.float().abs().max().item() + 2**-12 * size, (name, err, size)


# The backward's tiles are 128 keys and 64 query rows.
@pytest.mark.parametrize("tk", EDGE_LENGTHS)
@pytest.mark.parametrize("tq", EDGE_LENGTHS)
def test_attention_bwd_kernel_tile_edges(cuda, tq, tk):
    q, k, v = _qkv(1, 2, tq, tk, cuda, seed=1000 * tq + tk)
    mask = _causal(1, tq, tk, cuda) if tq == tk else None
    _assert_attention_bwd_matches_plain(q, k, v, mask, cuda_attention.virtual_keys(tq, tk))


@pytest.mark.parametrize("tk", (65, 511))
def test_attention_bwd_kernel_row_whose_only_key_is_the_last(cuda, tk):
    """Row 7 sees only key Tk - 1 (in the last, ragged key tile); row 3 sees
    none (its real keys all masked: the virtual keys take the softmax)."""
    q, k, v = _qkv(1, 2, 30, tk, cuda, seed=tk + 1)
    mask = torch.zeros(1, 30, tk)
    mask[:, 7, : tk - 1] = -1e4
    mask[:, 3] = -1e4
    _assert_attention_bwd_matches_plain(q, k, v, mask.to(cuda), cuda_attention.virtual_keys(30, tk))


@pytest.mark.parametrize("case", ["decoder-self", "cross-training"])
def test_attention_bwd_kernel_is_deterministic(cuda, case):
    """No atomics: two calls on the same inputs give the same bits."""
    q, k, v, mask, n_virtual = _attention_inputs(case, cuda)
    out, lse = cuda_attention.fused_attention(q, k, v, mask, n_virtual)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(3)).to(cuda, torch.bfloat16)
    first = cuda_attention.fused_attention_bwd(q, k, v, mask, out, lse, do)
    second = cuda_attention.fused_attention_bwd(q, k, v, mask, out, lse, do)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_fused_attention_autograd_launches_both_kernels(cuda):
    q, k, v, mask, n_virtual = _attention_inputs("ragged-causal", cuda)
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    f0, b0 = cuda_attention.fused_attention.launches, cuda_attention.fused_attention_bwd.launches
    cuda_attention.FusedAttention.apply(q, k, v, mask, n_virtual).float().sum().backward()
    torch.cuda.synchronize()
    assert cuda_attention.fused_attention.launches == f0 + 1
    assert cuda_attention.fused_attention_bwd.launches == b0 + 1
    assert all(t.grad is not None and torch.isfinite(t.grad.float()).all() for t in (q, k, v))


def test_attention_kernel_rejects_what_it_cannot_hold(cuda):
    q = torch.zeros(1, 1, 600, 128, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="keys"):
        cuda_attention.fused_attention(q, q, q)
    with pytest.raises(ValueError, match="bf16"):
        cuda_attention.fused_attention(*(torch.zeros(1, 1, 8, 128, device=cuda),) * 3)


def _ffn_inputs(n, d, d_ff, cuda, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g)
    w1 = torch.randn(d_ff, d, generator=g) / d**0.5
    w2 = torch.randn(d, d_ff, generator=g) / d_ff**0.5
    b1, b2 = torch.randn(d_ff, generator=g) * 0.1, torch.randn(d, generator=g) * 0.1
    seeds = seed_from_key((seed, 7)) + seed_from_key((seed + 1, 9))
    return tuple(t.to(cuda, torch.bfloat16) for t in (x, w1, b1, w2, b2)), seeds


# Tolerances: the same bf16 operands with fp32 accumulation in another order;
# pre and out are rounded to bf16 on both sides, so a rounding flip moves an
# element by 1 bf16 ulp (at most 2^-7 of its size; pre also by the fp32
# cancellation error near 0), and a flipped pre moves the hidden by as much.
# The masks are the same hash on both sides: the zero patterns are equal.
# The GEMM tiles are 128 x 128: N below, at and past a tile's edge, d_ff an
# odd count of tiles, and the widths other than the model's 768.
@pytest.mark.parametrize(
    "n, d, d_ff, keep",
    [(100, 768, 512, 0.65), (250, 768, 1536, 0.9), (2 * 511, 768, 3072, 0.9), (37, 768, 512, 0.9),
     (64 * 246 + 1, 768, 3072, 0.9), (300, 768, 640, 0.8), (200, 512, 2048, 0.9), (130, 1024, 384, 0.7)],
    ids=["small", "mid", "training-width", "under-64-rows", "encoder-rows-plus-1", "odd-tiles-d_ff", "d512",
         "d1024"],
)
def test_ffn_dropout_kernel_matches_plain(cuda, n, d, d_ff, keep):
    args, seeds = _ffn_inputs(n, d, d_ff, cuda)
    before = cuda_ffn.ffn_dropout.launches
    out, pre = cuda_ffn.ffn_dropout(*args, seeds, keep, keep)
    torch.cuda.synchronize()
    assert cuda_ffn.ffn_dropout.launches == before + 1
    ref, ref_pre = ffn_dropout_plain(*args, seeds, keep, keep)
    assert out.shape == ref.shape and pre.shape == ref_pre.shape and out.dtype == torch.bfloat16
    assert torch.equal(out == 0, ref == 0)
    assert abs((out == 0).float().mean().item() - (1 - keep)) < 0.02
    pre_err = (pre.float() - ref_pre.float()).abs()
    assert (pre_err <= 2**-7 * ref_pre.float().abs() + 1e-4 * ref_pre.float().abs().max()).all()
    assert (out.float() - ref.float()).abs().max().item() <= 2**-7 * ref.float().abs().max().item()


def test_ffn_dropout_kernel_rejects_what_it_cannot_hold(cuda):
    (x, w1, b1, w2, b2), seeds = _ffn_inputs(8, 768, 512, cuda)
    with pytest.raises(ValueError, match="bf16"):
        cuda_ffn.ffn_dropout(x.float(), w1, b1, w2, b2, seeds, 0.9, 0.9)
    (x, w1, b1, w2, b2), seeds = _ffn_inputs(8, 200, 512, cuda)
    with pytest.raises(ValueError, match="multiples of 128"):
        cuda_ffn.ffn_dropout(x, w1, b1, w2, b2, seeds, 0.9, 0.9)


# K2 and K3 are bit-equal to their plain versions: the same f32 operations,
# each rounded on its own, in the same order (torch.equal).
@pytest.mark.parametrize(
    "n_rows, L, n, dtype",
    [(37, 256, 13, torch.float32), (200, 30720, 1727, torch.bfloat16), (50, 1001, 8, torch.bfloat16),
     (21, 250, 6, torch.float32)],
    ids=["f32-odd-n", "bf16-training-row", "bf16-scalar-row", "f32-scalar-row"],
)
def test_gather_blend_kernel_matches_plain(cuda, n_rows, L, n, dtype):
    g = torch.Generator().manual_seed(n)
    table = torch.randn(n_rows, L, generator=g).to(cuda, dtype)
    im, isub = (torch.randint(0, n_rows, (n,), generator=g).to(cuda) for _ in range(2))
    lam = (torch.rand(n, generator=g) * 0.8).to(cuda)
    before = cuda_place.gather_blend.launches
    out = cuda_place.gather_blend(table, im, isub, lam)
    torch.cuda.synchronize()
    assert cuda_place.gather_blend.launches == before + 1
    assert out.dtype == dtype and out.shape == (n, L)
    assert torch.equal(out, gather_blend_plain(table, im, isub, lam))


def test_gather_blend_kernel_reaches_rows_past_2_31_elements(cuda):
    """Row offsets are 64-bit: a bank of 71,000 rows of 30720 holds more
    than 2^31 elements (4.4 GB in bf16)."""
    n_rows, L = 71_000, 30720
    table = torch.zeros(n_rows, L, dtype=torch.bfloat16, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    for r in (0, n_rows - 2, n_rows - 1):
        table[r] = torch.randn(L, generator=g, device=cuda).to(torch.bfloat16)
    im = torch.tensor([n_rows - 1, 0, n_rows - 2], device=cuda)
    isub = torch.tensor([0, n_rows - 1, n_rows - 1], device=cuda)
    lam = torch.tensor([0.25, 0.5, 0.7], device=cuda)
    out = cuda_place.gather_blend(table, im, isub, lam)
    ref = gather_blend_plain(table, im, isub, lam)
    assert torch.equal(out, ref) and out.float().abs().amin(1).max() > 0
    del table


def _notes_case(B, S, L, N, chunk, seed, cuda):
    g = torch.Generator().manual_seed(seed)
    blend = torch.randn(B, S, L, generator=g)
    slot = torch.randint(0, S, (B, N), generator=g)
    onset = torch.randint(0, chunk, (B, N), generator=g)
    gain = torch.rand(B, N, generator=g) + 0.1
    gain[:, 4::5] = 0.0  # silent notes are skipped
    onset[:, 0], onset[:, 1], onset[:, 2] = 0, chunk - 1, onset[:, 3]  # first sample, last sample, overlap
    return blend.to(cuda), slot.to(cuda), onset.to(cuda), gain.to(cuda)


@pytest.mark.parametrize(
    "B, S, L, N, chunk, dtype",
    [(64, 27, 30720, 128, 61440, torch.bfloat16), (3, 4, 300, 300, 1000, torch.float32),
     (2, 27, 30720, 128, 61440, torch.float32), (5, 2, 128, 11, 512, torch.bfloat16)],
    ids=["training-bf16", "many-notes-f32", "training-f32", "small-bf16"],
)
def test_place_notes_kernel_matches_plain(cuda, B, S, L, N, chunk, dtype):
    blend, slot, onset, gain = _notes_case(B, S, L, N, chunk, B + N, cuda)
    blend = blend.to(dtype)
    before = cuda_place.place_notes.launches
    out = cuda_place.place_notes(blend, slot, onset, gain, chunk)
    torch.cuda.synchronize()
    assert cuda_place.place_notes.launches == before + 1
    ref = place_notes_plain(blend, slot, onset, gain, chunk)
    assert out.dtype == torch.float32 and out.shape == (B, chunk)
    assert torch.equal(out, ref)
    assert (out[:, chunk - 1] != 0).all()  # the note at the last sample lands there


def test_place_kernels_reject_what_they_cannot_hold(cuda):
    with pytest.raises(ValueError, match="f32 or bf16"):
        cuda_place.gather_blend(torch.zeros(4, 8, dtype=torch.float16, device=cuda), *(
            torch.zeros(2, dtype=torch.int64, device=cuda),) * 2, torch.zeros(2, device=cuda))
    with pytest.raises(ValueError, match="must lie on"):
        cuda_place.place_notes(torch.zeros(1, 2, 8, device=cuda), torch.zeros(1, 3, dtype=torch.int64),
                               torch.zeros(1, 3, dtype=torch.int64), torch.zeros(1, 3), 16)


@pytest.mark.parametrize("L, dtype", [(30720, torch.bfloat16), (250, torch.float32)], ids=["bf16-vector", "f32-scalar"])
def test_place_kernels_clamp_out_of_range_ids(cuda, L, dtype):
    """A row id >= n_rows (or < 0), a slot outside [0, S) or an onset outside
    [0, chunk) is clamped into its range, as the plain versions clamp it:
    nothing is read out of bounds and the two stay bit-equal."""
    n_rows = 9
    g = torch.Generator().manual_seed(L)
    table = torch.randn(n_rows, L, generator=g).to(cuda, dtype)
    im = torch.tensor([n_rows, n_rows + 1000, -3, 4], device=cuda)
    isub = torch.tensor([-1, 2, n_rows - 1, 10**6], device=cuda)
    lam = torch.tensor([0.1, 0.4, 0.5, 0.7], device=cuda)
    out = cuda_place.gather_blend(table, im, isub, lam)
    assert torch.equal(out, gather_blend_plain(table, im, isub, lam))
    assert torch.equal(out, cuda_place.gather_blend(table, im.clamp(0, n_rows - 1), isub.clamp(0, n_rows - 1), lam))
    blend, slot, onset, gain = _notes_case(2, 3, L, 12, 4 * L, 5, cuda)
    blend = blend.to(dtype)
    slot[0, :3] = torch.tensor([3, 50, -1])
    onset[1, :3] = torch.tensor([-7, 4 * L, 10**7])
    out = cuda_place.place_notes(blend, slot, onset, gain, 4 * L)
    assert torch.equal(out, place_notes_plain(blend, slot, onset, gain, 4 * L))
    assert torch.equal(out, cuda_place.place_notes(blend, slot.clamp(0, 2), onset.clamp(0, 4 * L - 1), gain, 4 * L))
