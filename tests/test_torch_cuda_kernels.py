"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips without a CUDA device. On the machine with the
card run them with `python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda_kernels.py` (`--noconftest`: `tests/conftest.py`
imports JAX, which that machine does not have). This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from adt_str_tpu_torch.clap.features import ClapFeatureExtractor, _clap_mel_params, device_log_mel_db
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


def test_log_mel_kernel_at_the_clap_frontend(cuda):
    """K1 at CLAP's frontend (`clap/features.py:device_log_mel_db`): 48 kHz,
    n_fft 1024, hop 480, 64 mels to 14 kHz, dB, no trim, on (4, 480000)
    repeat-padded one-shots (silent tails at the 1e-10 floor) and noise:
    1001 frames, 7 frame tiles of 128 and one of 105, the centred reflect
    padding at both ends. Tolerance as the dB case above."""
    rng = np.random.default_rng(10)
    fx = ClapFeatureExtractor()
    rows = [fx._pad_short(rng.normal(size=n) * 0.4) for n in (13_001, 48_000, 7919)]
    wave = torch.from_numpy(np.stack([*rows, rng.normal(size=480_000) * 0.3]).astype(np.float32)).to(cuda)
    params = _clap_mel_params()
    before = cuda_mel.log_mel.launches
    out = device_log_mel_db(wave)
    torch.cuda.synchronize()
    assert cuda_mel.log_mel.launches == before + 1
    ref = cuda_mel.log_mel_plain(wave, params, trim=False)
    assert out.shape == ref.shape == (4, 1001, 64)
    assert torch.isfinite(out).all() and out[0].min().item() < -99.99
    assert (out - ref).abs().max().item() <= 1e-3


def _assert_log_mel_matches_plain(wave, params, trim=True):
    before = cuda_mel.log_mel.launches
    out = cuda_mel.log_mel(wave, params, trim)
    torch.cuda.synchronize()
    assert cuda_mel.log_mel.launches == before + 1
    ref = cuda_mel.log_mel_plain(wave, params, trim)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= (1e-3 if params.log_mode == "db" else 1e-4)


@pytest.mark.parametrize("batch", [1, 12, 16, 24, 64])
def test_log_mel_kernel_batches(cuda, batch):
    """The serving, transcription and training batches (12 and 24: the 30 s
    transcription plain and with a 1.28 s hop): one frequency split at
    every batch, from a chunk's shape (4 blocks share a frame tile)."""
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
    blend = torch.randn(B, S, L, generator=g).to(torch.bfloat16)
    slot = torch.randint(0, S, (B, N), generator=g)
    onset = torch.randint(0, chunk, (B, N), generator=g)
    gain = torch.rand(B, N, generator=g) + 0.1
    gain[:, 4::5] = 0.0  # silent notes are skipped
    if N >= 4:
        onset[:, 0], onset[:, 1], onset[:, 2] = 0, chunk - 1, onset[:, 3]  # first sample, last sample, overlap
    return blend.to(cuda), slot.to(cuda), onset.to(cuda), gain.to(cuda)


def _place_and_check(blend, slot, onset, gain, chunk):
    """K3 once (one launch), bit-equal to its plain version; -> the output."""
    before = cuda_place.place_notes.launches
    out = cuda_place.place_notes(blend, slot, onset, gain, chunk)
    torch.cuda.synchronize()
    assert cuda_place.place_notes.launches == before + 1
    ref = place_notes_plain(blend, slot, onset, gain, chunk)
    assert out.dtype == torch.float32 and out.shape == (blend.shape[0], chunk)
    assert torch.equal(out, ref)
    return out


@pytest.mark.parametrize(
    "B, S, L, N, chunk",
    [(64, 27, 30720, 128, 61440), (3, 4, 304, 300, 1000), (2, 27, 30720, 128, 61440), (5, 2, 128, 11, 512)],
    ids=["training", "many-notes", "training-b2", "small"],
)
def test_place_notes_kernel_matches_plain(cuda, B, S, L, N, chunk):
    out = _place_and_check(*_notes_case(B, S, L, N, chunk, B + N, cuda), chunk)
    assert (out[:, chunk - 1] != 0).all()  # the note at the last sample lands there


def _edge_case(name, tile, cuda):
    """(blend, slot, onset, gain, chunk) for one edge of K3's tiling."""
    g = torch.Generator().manual_seed(len(name))
    if name == "more-notes-than-ring-slots":  # all 128 notes at onset 0 cover the first two tiles
        B, S, L, chunk = 2, 27, 2 * tile + 8, 3 * tile
        onset = torch.zeros(B, 128, dtype=torch.int64)
    elif name == "row-ends-inside-a-tile":
        B, S, L, chunk = 3, 4, 1000, 2 * tile
        onset = torch.tensor([[100, tile - 500, tile + 7, 2 * tile - 1001]] * B)
    elif name == "no-notes":
        B, S, L, chunk = 2, 4, 512, tile + 64
        onset = torch.zeros(B, 0, dtype=torch.int64)
    elif name == "one-note":
        B, S, L, chunk = 2, 4, 4096, 2 * tile
        onset = torch.tensor([[tile - 3], [5]])
    elif name == "one-segment":
        B, S, L, chunk = 1, 27, 30720, 61440
        onset = torch.randint(0, chunk, (B, 40), generator=g)
    elif name == "chunk-not-a-multiple-of-the-tile":
        B, S, L, chunk = 2, 5, 3000, 2 * tile + 1234
        onset = torch.randint(0, chunk, (B, 30), generator=g)
        onset[:, 0], onset[:, 1] = chunk - 1, 2 * tile - 10
    else:  # "onset-residue-<r>": every residue mod 8 of a note's shift, around the first tile edge
        r = int(name.rsplit("-", 1)[1])
        B, S, L, chunk = 2, 3, 2000, 3 * tile
        onset = torch.tensor([[tile - 8 + r, tile + r, tile - 1000 + r, r, tile - 2000 + r, 3 * tile - 5 + r,
                               2 * tile - 3 + r, 8 + r]] * B)
    N = onset.shape[1]
    blend = torch.randn(B, S, L, generator=g).to(torch.bfloat16)
    slot = torch.randint(0, S, (B, N), generator=g)
    gain = torch.rand(B, N, generator=g) + 0.1
    return blend.to(cuda), slot.to(cuda), onset.clamp(max=chunk - 1).to(cuda), gain.to(cuda), chunk


@pytest.mark.parametrize(
    "name",
    [*(f"onset-residue-{r}" for r in range(8)), "row-ends-inside-a-tile", "more-notes-than-ring-slots",
     "no-notes", "one-note", "one-segment", "chunk-not-a-multiple-of-the-tile"],
)
def test_place_notes_kernel_edges(cuda, name):
    tile = cuda_place.place_notes_layout()["tile"]
    blend, slot, onset, gain, chunk = _edge_case(name, tile, cuda)
    out = _place_and_check(blend, slot, onset, gain, chunk)
    if name == "no-notes":
        assert (out == 0).all()
    elif name != "one-segment":
        assert (out != 0).any(dim=1).all()


def test_place_notes_kernel_is_deterministic(cuda):
    blend, slot, onset, gain = _notes_case(64, 27, 30720, 128, 61440, 7, cuda)
    first = cuda_place.place_notes(blend, slot, onset, gain, 61440)
    second = cuda_place.place_notes(blend, slot, onset, gain, 61440)
    assert torch.equal(first, second)


def test_place_notes_kernel_takes_only_bf16_rows_on_16_byte_boundaries(cuda):
    slot = torch.zeros(1, 3, dtype=torch.int64, device=cuda)
    onset, gain = torch.zeros_like(slot), torch.ones(1, 3, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        cuda_place.place_notes(torch.zeros(1, 2, 64, device=cuda), slot, onset, gain, 128)
    with pytest.raises(ValueError, match="L % 8 == 0"):
        cuda_place.place_notes(torch.zeros(1, 2, 60, dtype=torch.bfloat16, device=cuda), slot, onset, gain, 128)
    unaligned = torch.zeros(2 * 64 + 1, dtype=torch.bfloat16, device=cuda)[1:].view(1, 2, 64)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        cuda_place.place_notes(unaligned, slot, onset, gain, 128)


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
    nothing is read out of bounds and the two stay bit-equal. K2 runs in the
    table's dtype; K3 takes bf16 rows of L rounded down to a multiple of 8."""
    n_rows = 9
    g = torch.Generator().manual_seed(L)
    table = torch.randn(n_rows, L, generator=g).to(cuda, dtype)
    im = torch.tensor([n_rows, n_rows + 1000, -3, 4], device=cuda)
    isub = torch.tensor([-1, 2, n_rows - 1, 10**6], device=cuda)
    lam = torch.tensor([0.1, 0.4, 0.5, 0.7], device=cuda)
    out = cuda_place.gather_blend(table, im, isub, lam)
    assert torch.equal(out, gather_blend_plain(table, im, isub, lam))
    assert torch.equal(out, cuda_place.gather_blend(table, im.clamp(0, n_rows - 1), isub.clamp(0, n_rows - 1), lam))
    L = L // 8 * 8
    blend, slot, onset, gain = _notes_case(2, 3, L, 12, 4 * L, 5, cuda)
    slot[0, :3] = torch.tensor([3, 50, -1])
    onset[1, :3] = torch.tensor([-7, 4 * L, 10**7])
    out = cuda_place.place_notes(blend, slot, onset, gain, 4 * L)
    assert torch.equal(out, place_notes_plain(blend, slot, onset, gain, 4 * L))
    assert torch.equal(out, cuda_place.place_notes(blend, slot.clamp(0, 2), onset.clamp(0, 4 * L - 1), gain, 4 * L))


def test_run_inference_on_the_card_launches_k1_and_k5f(cuda, tmp_path, caplog):
    """The eval harness on the card over a small in-memory dataset (a short
    item and an empty reference among five items, batches of 2) with K1 and
    K5f on: K1 launches once a batch and K5f once an encoder layer a batch,
    TP + FN is the reference's notes, and the written metrics are the
    returned ones."""
    import json
    import logging

    from adt_str_tpu_torch.config import InferenceConfig, ModelConfig, TokenizerConfig
    from adt_str_tpu_torch.domain.tokenizer import MidiTokenizer
    from adt_str_tpu_torch.evaluation.harness import run_inference
    from adt_str_tpu_torch.models.adt import ADTModel

    cfg = ModelConfig(sample_rate=8000, win_length=512, time_res=0.01, input_sec=0.64, enc_layers=2, dec_layers=1,
                      nhead=2, d_query=128, n_mels=64, max_positions=64, use_pallas_mel=True,
                      use_flash_attention=True)
    rng = np.random.default_rng(3)
    wavs = [(rng.normal(size=n) * 0.3).astype(np.float32) for n in (5120, 5120, 2400, 5120, 5120)]
    notes = [np.stack([on, on + 0.1, rng.choice([35, 38, 42], 6), np.full(6, 90)], 1) for on in
             rng.uniform(0, 0.5, (5, 6))]
    notes[3] = np.zeros((0, 4), np.float32)

    class Items:
        def batches(self, batch_size):
            for b in range(0, 5, batch_size):
                yield {"wavs": wavs[b : b + batch_size], "notes": notes[b : b + batch_size]}

    model = ADTModel(cfg, seed=0, device=cuda)
    tok = MidiTokenizer(TokenizerConfig(ADTOF_mapping=True))
    before = (cuda_mel.log_mel.launches, cuda_attention.fused_attention.launches)
    caplog.set_level(logging.INFO, logger="adt_str_tpu_torch.evaluation.harness")
    metrics = run_inference(model, cfg, Items(), tok, InferenceConfig(batch_size=2, max_length=12,
                                                                      output_path=str(tmp_path)), device="cuda")
    assert (cuda_mel.log_mel.launches - before[0], cuda_attention.fused_attention.launches - before[1]) == (3, 6)
    (record,) = [r for r in caplog.records if r.msg.startswith("eval items=")]
    items, tp, fn, fp = record.args
    assert items == 5 and tp + fn == sum(len(n) for n in notes) and fp >= 0
    assert json.loads((tmp_path / "metrics.json").read_text()) == metrics
    assert all(np.isfinite(v) for m in metrics.values() for v in m.values())


# The training job trims note batches to 16-slot buckets and token batches to
# 64-token buckets (`data/datasets.py`): K3 at the trimmed note buckets of a
# setting-1 batch, K5f and K5b at the decoder's lengths of a token bucket
# (bucket - 1 inputs: self-attention with the causal + padding mask, and
# cross-attention over the 246 encoder frames).
@pytest.mark.parametrize("slots", [16, 32, 48])
def test_place_notes_kernel_at_the_trainers_note_buckets(cuda, slots):
    out = _place_and_check(*_notes_case(64, 27, 30720, slots, 61440, slots, cuda), 61440)
    assert (out[:, 61439] != 0).all()


TOKEN_BUCKET_CASES = {"self-127": (8, 6, 127, 127, "causal"), "cross-127": (8, 6, 127, 246, None),
                      "self-191": (4, 6, 191, 191, "causal"), "cross-191": (4, 6, 191, 246, None)}


@pytest.mark.parametrize("case", list(TOKEN_BUCKET_CASES))
def test_attention_kernels_at_the_trainers_token_buckets(cuda, case):
    B, H, Tq, Tk, kind = TOKEN_BUCKET_CASES[case]
    q, k, v = _qkv(B, H, Tq, Tk, cuda, seed=Tq)
    mask = None
    if kind == "causal":  # padding past each row's length, as the trainer's masks have
        lengths = torch.randint(Tk // 4, Tk + 1, (B,), generator=torch.Generator().manual_seed(Tq))
        pad = torch.where(torch.arange(Tk)[None] >= lengths[:, None], -1e4, 0.0)
        mask = _causal(B, Tq, Tk, cuda) + pad[:, None, :].to(cuda)
    _assert_attention_matches_plain(q, k, v, mask, cuda_attention.virtual_keys(Tq, Tk))
    _assert_attention_bwd_matches_plain(q, k, v, mask, cuda_attention.virtual_keys(Tq, Tk))


# ---------------------------------------------------- the batch-invariance kernels
# LayerNorm, the inference product and the inference attention
# (`ops/{layer_norm,linear,attention_rows}.py`): each against its plain
# version, and each row's bits the same at every row count.

from adt_str_tpu_torch.ops import attention_rows  # noqa: E402
from adt_str_tpu_torch.ops import layer_norm as ln_ops  # noqa: E402
from adt_str_tpu_torch.ops import linear as linear_ops  # noqa: E402

ROW_COUNTS = (1, 2, 3, 4, 7, 8, 16, 31, 32, 63, 64)


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 at |t| (8 significant bits); below 2^-6, that of 2^-6."""
    return torch.exp2(torch.floor(torch.log2(t.float().abs().clamp(min=2.0**-6))) - 7)


def _ln_inputs(rows, d, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(rows, d, generator=g, device=device) * 2.0 + 0.5).to(dtype)
    w = 1.0 + 0.1 * torch.randn(d, generator=g, device=device)
    b = 0.1 * torch.randn(d, generator=g, device=device)
    return x, w, b


# bf16: 1 ulp of the plain output (an output below 2^-6 counts as 2^-6: there
# y = p + b cancels and the two sides' fp32 statistics, summed in other
# orders, leave p's last fp32 bits apart); fp32: 1e-5
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("d", [48, 768, 1000, 1024])
def test_layer_norm_kernel_matches_plain(cuda, d, dtype):
    x, w, b = _ln_inputs(37, d, dtype, cuda)
    before = ln_ops.layer_norm.launches
    with torch.inference_mode():
        out = ln_ops.layer_norm(x, w, b, 1e-5)
    torch.cuda.synchronize()
    assert ln_ops.layer_norm.launches == before + 1 and out.dtype == dtype
    ref = ln_ops.layer_norm_plain(x, w, b, 1e-5)
    err = (out.float() - ref.float()).abs()
    if dtype == torch.bfloat16:
        assert bool((err <= _bf16_ulp(ref)).all()), (err / _bf16_ulp(ref)).max()
    else:
        assert err.max().item() <= 1e-5


def test_layer_norm_kernel_rows_bit_equal_at_every_row_count(cuda):
    x, w, b = _ln_inputs(64, 768, torch.bfloat16, cuda, seed=1)
    with torch.inference_mode():
        full = ln_ops.layer_norm(x[:, None], w, b, 1e-5)
        for r in ROW_COUNTS:
            assert torch.equal(ln_ops.layer_norm(x[:r, None].clone(), w, b, 1e-5), full[:r]), r


def test_layer_norm_keeps_autograd_in_training_and_rejects_on_the_card(cuda):
    """Training (grad enabled, an operand that requires it) runs the plain
    version under autograd and launches nothing; on the inference path an
    unsupported width or dtype raises."""
    x, w, b = _ln_inputs(4, 768, torch.bfloat16, cuda)
    w.requires_grad_(True)
    before = ln_ops.layer_norm.launches
    ln_ops.layer_norm(x, w, b, 1e-5).float().sum().backward()
    assert ln_ops.layer_norm.launches == before and w.grad is not None
    with torch.inference_mode():
        with pytest.raises(ValueError, match="layer_norm kernel"):
            ln_ops.layer_norm(torch.zeros(2, 1025, device=cuda), torch.ones(1025, device=cuda),
                              torch.zeros(1025, device=cuda), 1e-5)
        with pytest.raises(ValueError, match="layer_norm kernel"):
            ln_ops.layer_norm(x.half(), w.detach(), b, 1e-5)


def _linear_inputs(m, n, k, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=device).to(dtype)
    w = (torch.randn(n, k, generator=g, device=device) / k**0.5).to(dtype)
    b = (0.1 * torch.randn(n, generator=g, device=device)).to(dtype)
    return x, w, b


# bf16 against the fp32 product rounded as the plain version rounds it (the
# product to bf16, then the bias): the sums run in other orders, so a rounding
# may flip: 1 ulp of the product plus 1 of the output; fp32: 1e-5 of max(1, |y|)
@pytest.mark.parametrize("m, n, k", [(1, 3072, 768), (16, 2304, 768), (80, 1400, 768), (3936, 768, 3072),
                                     (5, 70, 40), (130, 129, 264)])
def test_linear_kernel_matches_the_fp32_product(cuda, m, n, k):
    x, w, b = _linear_inputs(m, n, k, torch.bfloat16, cuda)
    before = linear_ops.linear.launches
    with torch.inference_mode():
        out = linear_ops.linear(x, w, b)
        x32, w32, b32 = _linear_inputs(m, n, k, torch.float32, cuda, seed=1)
        out32 = linear_ops.linear(x32, w32, b32)
    torch.cuda.synchronize()
    assert linear_ops.linear.launches == before + 2
    prod = (x.float() @ w.float().T).to(torch.bfloat16)
    ref = (prod + b).float()
    assert bool(((out.float() - ref).abs() <= _bf16_ulp(prod) + _bf16_ulp(ref)).all())
    ref32 = torch.addmm(b32.double(), x32.double(), w32.double().T)
    assert ((out32.double() - ref32).abs() / ref32.abs().clamp(min=1.0)).max().item() <= 1e-5


def test_linear_kernel_rows_bit_equal_at_every_row_count(cuda):
    """The decode step's and the beam's rows (up to 64 x 5) and the encoder's
    chunks of 246 frames."""
    for rows_per, n, k in ((1, 3072, 768), (5, 2304, 768), (246, 768, 3072)):
        x, w, b = _linear_inputs(64 * rows_per, n, k, torch.bfloat16, cuda, seed=rows_per)
        with torch.inference_mode():
            full = linear_ops.linear(x, w, b)
            for r in ROW_COUNTS:
                assert torch.equal(linear_ops.linear(x[: r * rows_per].clone(), w, b), full[: r * rows_per]), (rows_per, r)


def test_linear_kernel_rejects_what_it_cannot_hold(cuda):
    with torch.inference_mode(), pytest.raises(ValueError, match="linear kernel"):
        linear_ops.linear(torch.zeros(2, 44, device=cuda, dtype=torch.bfloat16),
                          torch.zeros(8, 44, device=cuda, dtype=torch.bfloat16))


ATTENTION_ROWS_CASES = {  # (B, Tq, Tk, head dim, the decode step's position or None: no mask, dtype)
    "decode-self": (16, 1, 512, 128, 255, torch.bfloat16),
    "decode-cross": (16, 1, 246, 128, None, torch.bfloat16),
    "beam-cross": (16, 5, 246, 128, None, torch.bfloat16),
    "encoder": (2, 246, 246, 128, None, torch.bfloat16),
    "fp32-small-head": (3, 2, 40, 64, 7, torch.float32),
}


def _rows_inputs(B, tq, tk, hd, step, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(B, 6, t, hd, generator=g, device=device).to(dtype) for t in (tq, tk, tk))
    mask = None if step is None else torch.where(torch.arange(tk, device=device) > step, -1e4, 0.0)[None, None, None]
    return q, k, v, mask


# Both sides round the probabilities to bf16, and their fp32 sums in other
# orders can flip one such rounding: that moves an output by a bf16 ulp of
# the probability times v, and the output's own rounding may then flip. So
# each output lies within 1 bf16 ulp of itself plus 2 ulps of its row's
# largest probability times its column's largest |v|; a flip moves an output
# by about 2^-8 / keys of its size, so at most 2% of the outputs differ at
# all (a kernel that skips the probabilities' rounding moves about 40%, one
# that rounds its scores to bf16 about 60%). fp32: within 1e-5.
@pytest.mark.parametrize("case", list(ATTENTION_ROWS_CASES))
def test_attention_rows_kernel_matches_plain(cuda, case):
    q, k, v, mask = _rows_inputs(*ATTENTION_ROWS_CASES[case], cuda)
    before = attention_rows.attention.launches
    with torch.inference_mode():
        out = attention_rows.attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert attention_rows.attention.launches == before + 1
    ref = attention_rows.attention_plain(q, k, v, mask).float()
    err = (out.float() - ref).abs()
    if q.dtype == torch.float32:
        assert err.max().item() <= 1e-5
        return
    p_max = attention_rows.attention_probs(q, k, mask).float().amax(-1, keepdim=True)
    spacing = lambda t: torch.exp2(torch.floor(torch.log2(t.abs().clamp(min=2.0**-126))) - 7)  # noqa: E731
    bound = spacing(ref) + 2 * spacing(p_max) * v.float().abs().amax(2, keepdim=True)
    assert (err <= bound).all(), (err / bound).max().item()
    assert (err > 0).double().mean().item() <= 0.02


def test_attention_rows_kernel_rows_bit_equal_at_every_row_count(cuda):
    for case in ("decode-self", "beam-cross"):
        _, tq, tk, hd, step, dtype = ATTENTION_ROWS_CASES[case]
        q, k, v, mask = _rows_inputs(64, tq, tk, hd, step, dtype, cuda, seed=2)
        with torch.inference_mode():
            full = attention_rows.attention(q, k, v, mask)
            for r in ROW_COUNTS:
                part = attention_rows.attention(q[:r].clone(), k[:r].clone(), v[:r].clone(), mask)
                assert torch.equal(part, full[:r]), (case, r)


def test_attention_rows_kernel_rejects_what_it_cannot_hold(cuda):
    q, k, v, _ = _rows_inputs(1, 1, 8, 128, None, torch.bfloat16, cuda)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="attention_rows kernel"):
            attention_rows.attention(q, k.float(), v, None)
        big = torch.zeros(1, 6, 5000, 128, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="attention_rows kernel"):
            attention_rows.attention(q, big, big, None)


def test_log_mel_kernel_row_bits_equal_at_every_batch(cuda):
    """K1's split follows the batch (8, 4, 1 at B 1, 16, 64) but its band
    sums run in frequency-tile order, so a chunk's bits are the same at B 1,
    16 and 64 (serving buckets and the training batch)."""
    wave = _wave(64, 61440, seed=7).to(cuda)
    full = cuda_mel.log_mel(wave, SERVING_MEL)
    for b in (1, 2, 16, 64):
        assert torch.equal(cuda_mel.log_mel(wave[:b].clone(), SERVING_MEL), full[:b]), b


@pytest.mark.parametrize("frontend", ["serving", "clap"])
def test_log_mel_kernel_bits_equal_at_every_split(cuda, frontend, monkeypatch):
    """Every split the wrapper can pick (1 up to the frequency tiles) gives
    the same bits, the model's frontend and CLAP's dB frontend."""
    from adt_str_tpu_torch.clap.features import _clap_mel_params

    params, n, trim = (SERVING_MEL, 61440, True) if frontend == "serving" else (_clap_mel_params(), 480_000, False)
    wave = _wave(4, n, seed=8).to(cuda)
    n_tiles = cuda_mel.mel_table(params).shape[0] // cuda_mel.FREQ_TILE
    outs = {}
    for split in (1, 2, 3, 4, 8):
        if split <= n_tiles:
            monkeypatch.setattr(cuda_mel, "freq_split", lambda *_: split)
            outs[split] = cuda_mel.log_mel(wave, params, trim)
    assert len(outs) > 2 and all(torch.equal(o, outs[1]) for o in outs.values())


def test_a_full_width_chunk_decodes_alone_as_in_a_batch_of_16(cuda):
    """The serving config at full width (d 768, 6 heads of 128, 4 + 4
    layers, K1 and K5f on), seeded random weights: one chunk's greedy tokens
    alone and at row 5 of a batch of 16 other chunks are equal."""
    from pathlib import Path

    from adt_str_tpu_torch.config import FrameworkConfig
    from adt_str_tpu_torch.models.adt import ADTModel
    from adt_str_tpu_torch.models.decode import greedy_decode

    cfg = FrameworkConfig.from_yaml(Path(__file__).resolve().parent.parent / "configs/serve/ENSTserving.yaml")
    model = ADTModel(cfg.model, seed=0, device=cuda)
    batch = _wave(16, cfg.shared.chunk_samples, seed=11).to(cuda)
    alone = greedy_decode(model, batch[5:6].clone(), cfg.inference.max_length)
    inside = greedy_decode(model, batch, cfg.inference.max_length)[5:6]
    assert torch.equal(alone, inside)
