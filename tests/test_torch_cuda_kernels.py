"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips without a CUDA device. On the machine with the
card run them with `python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda_kernels.py` (`--noconftest`: `tests/conftest.py`
imports JAX, which that machine does not have). This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from adt_str_tpu_torch.ops import cuda_attention, cuda_mel
from adt_str_tpu_torch.ops.mel import MelFrontendParams

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


def test_log_mel_kernel_silence(cuda):
    out = cuda_mel.log_mel(torch.zeros(2, 61440, device=cuda), SERVING_MEL)
    assert out.abs().max().item() == 0.0


# Tolerances: scores and softmax agree to fp32 rounding; p is rounded to bf16
# on both sides and a rare ulp flip there moves out by ~1 bf16 ulp of |out|.
@pytest.mark.parametrize(
    "B, H, Tq, Tk, with_mask",
    [(2, 6, 246, 246, False), (2, 1, 30, 30, True), (1, 2, 10, 246, False), (1, 1, 256, 256, True)],
    ids=["encoder", "ragged-causal", "cross", "max-keys"],
)
def test_attention_kernel_matches_plain(cuda, B, H, Tq, Tk, with_mask):
    g = torch.Generator(device="cpu").manual_seed(0)
    q, k, v = (
        torch.randn(B, H, T, 128, generator=g).to(cuda, torch.bfloat16) for T in (Tq, Tk, Tk)
    )
    mask = None
    if with_mask:
        mask = torch.triu(torch.full((Tq, Tk), -1e4), diagonal=1).expand(B, Tq, Tk).to(cuda)
    before = cuda_attention.fused_attention.launches
    out, lse = cuda_attention.fused_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert cuda_attention.fused_attention.launches == before + 1
    ref, ref_lse = cuda_attention.attention_plain(q, k, v, mask)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape and lse.shape == ref_lse.shape
    assert (out.float() - ref.float()).abs().max().item() <= 1.6e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-4


def test_attention_kernel_rejects_what_it_cannot_hold(cuda):
    q = torch.zeros(1, 1, 300, 128, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="keys"):
        cuda_attention.fused_attention(q, q, q)
    with pytest.raises(ValueError, match="bf16"):
        cuda_attention.fused_attention(*(torch.zeros(1, 1, 8, 128, device=cuda),) * 3)
