"""K1's sparse mel table, grid split and bases, on the CPU (no card needed).

The log-mel kernel (`csrc/log_mel.cu`) replaces the dense bins x mels
product by a per-bin table (w0, w1, m0): an HTK triangular filterbank puts
each bin in at most two adjacent bands. These tests hold the table to
`mel_filterbank` at every frontend configuration the repo ships and at the
card tests' small ones, replay the kernel's in-order band sums (with the
frequency range split over blocks) in numpy against the dense product and
across splits, and check the bases against the Pallas kernel's `_constants`.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from adt_str_tpu.ops import mel as jmel
from adt_str_tpu.ops import pallas_mel
from adt_str_tpu_torch.clap.features import _clap_mel_params
from adt_str_tpu_torch.config import FrameworkConfig
from adt_str_tpu_torch.models.adt import mel_params
from adt_str_tpu_torch.ops import cuda_mel
from adt_str_tpu_torch.ops.mel import MelFrontendParams, mel_filterbank

REPO = Path(__file__).resolve().parent.parent
SHIPPED = sorted({*REPO.glob("configs/train/*.yaml"), *REPO.glob("configs/serve/*.yaml"), *REPO.glob("configs/eval/*.yaml")})
SMALL = [MelFrontendParams(sample_rate=8000, win_length=512, hop_length=80, n_mels=64),
         MelFrontendParams(sample_rate=16000, win_length=1024, hop_length=160, n_mels=80, f_max=7600.0)]


def _shipped_params():
    params = set()
    for path in SHIPPED:
        cfg = FrameworkConfig.from_yaml(str(path))
        params.add(mel_params(cfg.model))
    return sorted(params, key=repr)


CLAP = _clap_mel_params()  # CLAP's frontend: 48 kHz, n_fft 1024, hop 480, 64 mels to 14 kHz, dB
ALL_PARAMS = [*_shipped_params(), *SMALL, CLAP]


def _decode(table):
    t = table.numpy()
    return t[:, 0], t[:, 1], t[:, 2].copy().view(np.int32)


@pytest.mark.parametrize("params", ALL_PARAMS, ids=repr)
def test_mel_table_holds_the_filterbank(params):
    """At most two adjacent bands a bin, m0 nondecreasing, and the weights
    are mel_filterbank's own (bins past the table hold only residues)."""
    M = mel_filterbank(params.n_freqs, params.n_mels, params.sample_rate, params.f_min, params.f_max)
    table = cuda_mel.mel_table(params)
    assert table.shape[0] % cuda_mel.FREQ_TILE == 0 and table.shape[1] == 4
    w0, w1, m0 = _decode(table)
    assert (np.diff(m0) >= 0).all() and m0.min() >= 0 and m0.max() <= params.n_mels - 2
    rebuilt = np.zeros((table.shape[0], params.n_mels), np.float32)
    rows = np.arange(table.shape[0])
    rebuilt[rows, m0] = w0
    rebuilt[rows, m0 + 1] += w1
    k = min(table.shape[0], params.n_freqs)
    np.testing.assert_array_equal(rebuilt[:k], M[:k])
    assert (rebuilt[k:] == 0).all()
    assert (np.abs(M[k:]) <= 1e-10 * M.max()).all()
    assert ((M != 0).sum(axis=1) <= 2).all()


def test_serving_table_drops_only_the_f_max_residue():
    """The model's frontend: 1025 bins, of which the table keeps 1024 (eight
    tiles); the bin at f_max carries a 6.5e-15 rounding residue."""
    params = MelFrontendParams(sample_rate=24000, win_length=2048, hop_length=240, n_mels=128)
    assert cuda_mel.mel_table(params).shape[0] == 1024  # eight tiles
    M = mel_filterbank(1025, 128, 24000)
    assert 0 < M[1024].max() < 1e-14



@pytest.mark.parametrize("params", ALL_PARAMS, ids=repr)
def test_used_bins_are_the_weighted_bins(params):
    """`used_bins` (the table's bins and the smoke's bound count) ends at
    the last bin with a weight above the residue; at CLAP's frontend that is
    bin 298 (13968.75 Hz, the last below 14 kHz), at the model's bin 1023."""
    M = mel_filterbank(params.n_freqs, params.n_mels, params.sample_rate, params.f_min, params.f_max)
    k = cuda_mel.used_bins(params)
    assert M[k - 1].max() > 1e-10 * M.max()
    assert (np.abs(M[k:]) <= 1e-10 * M.max()).all()
    assert -(-k // cuda_mel.FREQ_TILE) * cuda_mel.FREQ_TILE == cuda_mel.mel_table(params).shape[0]
    if params == CLAP:
        assert k == 299
    if params == MelFrontendParams(sample_rate=24000, win_length=2048, hop_length=240, n_mels=128):
        assert k == 1024


def _kernel_mel(power, params, split):
    """numpy replay of the kernel's mel step for one frame: per band parity
    h, one running sum over the bins in order, restarted at each frequency
    tile, a band written when the next bin moves on. With split 1 the block
    adds a band's tile sums in tile order as it goes; with more, the split
    blocks write each tile's band sums to that tile's part, and each band
    adds its parts over its range of tiles (`band_tiles`) in tile order."""
    table = cuda_mel.mel_table(params)
    w0, w1, m0 = _decode(table)
    ft, n_mels = cuda_mel.FREQ_TILE, params.n_mels
    n_tiles = table.shape[0] // ft
    out = np.zeros(n_mels, np.float32)
    parts = np.full((n_tiles, n_mels), np.nan, np.float32)  # a part the kernel leaves unwritten is never read
    for s in range(split):
        for h in (0, 1):
            cur, acc, before = -1, np.float32(0), np.float32(0)
            for j in range(s * n_tiles // split * ft, (s + 1) * n_tiles // split * ft):
                if j % ft == 0 and j > s * n_tiles // split * ft:
                    if split == 1:
                        before = np.float32(before + acc)
                    elif cur >= 0:
                        parts[j // ft - 1, cur], cur = acc, -1
                    acc = np.float32(0)
                band = m0[j] + ((m0[j] ^ h) & 1)
                if band != cur:
                    if cur >= 0:
                        if split == 1:
                            out[cur] = np.float32(before + acc)
                        else:
                            parts[j // ft, cur] = acc
                    cur, acc, before = band, np.float32(0), np.float32(0)
                wt = w0[j] if (m0[j] & 1) == h else w1[j]
                acc = np.float32(acc + np.float32(wt * power[j]))
            if cur >= 0:
                if split == 1:
                    out[cur] = np.float32(before + acc)
                else:
                    parts[(s + 1) * n_tiles // split - 1, cur] = acc
    if split == 1:
        return out
    for m, (first, last) in enumerate(cuda_mel.band_tiles(params).numpy()):
        if first <= last:
            out[m] = parts[first, m]
            for tile in range(first + 1, last + 1):
                out[m] = np.float32(out[m] + parts[tile, m])
    return out


def _power(table, params, seed):
    rng = np.random.default_rng(seed)
    power = np.zeros(table.shape[0], np.float32)
    k = min(table.shape[0], params.n_freqs)
    power[:k] = (rng.normal(size=k) ** 2 * 10.0 ** rng.uniform(-4, 3, size=k)).astype(np.float32)
    return power


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("params", [ALL_PARAMS[0], SMALL[0], CLAP], ids=["model", "small", "clap"])
def test_in_order_band_sums_equal_the_dense_product(params, split):
    table = cuda_mel.mel_table(params)
    split = min(split, table.shape[0] // cuda_mel.FREQ_TILE)
    M = mel_filterbank(params.n_freqs, params.n_mels, params.sample_rate, params.f_min, params.f_max)
    power = _power(table, params, split)
    k = min(table.shape[0], params.n_freqs)
    dense = power[:k].astype(np.float64) @ M[:k].astype(np.float64)
    got = _kernel_mel(power, params, split)
    np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-30)


@pytest.mark.parametrize("params", [ALL_PARAMS[0], SMALL[0], CLAP], ids=["model", "small", "clap"])
def test_band_sums_are_the_same_bits_at_every_split(params):
    """The split follows the launch's size (`freq_split`), so a row's bits
    must not follow it: the tile-order sums give equal bits at every split."""
    table = cuda_mel.mel_table(params)
    n_tiles = table.shape[0] // cuda_mel.FREQ_TILE
    power = _power(table, params, 3)
    one = _kernel_mel(power, params, 1)
    assert np.isfinite(one).all()
    for split in (2, 4, 8):
        if split <= n_tiles:
            np.testing.assert_array_equal(_kernel_mel(power, params, split), one)


@pytest.mark.parametrize("params", [ALL_PARAMS[0], SMALL[0], CLAP], ids=["model", "small", "clap"])
def test_band_tiles_are_the_tiles_whose_bins_reach_each_band(params):
    """A band's parts lie in the contiguous range of tiles whose bins reach
    it (bin j reaches bands m0 and m0 + 1), and every band of a filterbank
    with weights is reached."""
    _, _, m0 = _decode(cuda_mel.mel_table(params))
    got = cuda_mel.band_tiles(params).numpy()
    assert got.shape == (params.n_mels, 2) and got.dtype == np.int32
    for m in range(params.n_mels):
        tiles = np.flatnonzero((m0 == m) | (m0 + 1 == m)) // cuda_mel.FREQ_TILE
        assert tiles.size and (got[m] == (tiles.min(), tiles.max())).all()


def test_freq_split_fills_one_wave():
    """The grid at the serving and training batches on 132 SMs: 2 frame
    tiles a 2.56 s chunk, 8 frequency tiles."""
    grid = {b: (2 * b, cuda_mel.freq_split(2 * b, 8, 132)) for b in (1, 16, 64)}
    assert grid == {1: (2, 8), 16: (32, 4), 64: (128, 1)}
    assert cuda_mel.freq_split(256, 8, 132) == 1 and cuda_mel.freq_split(4, 2, 132) == 2


@pytest.mark.parametrize("params", [ALL_PARAMS[0], SMALL[0], CLAP], ids=["model", "small", "clap"])
def test_bases_equal_the_pallas_constants(params):
    C, S, M = cuda_mel._constants(params)
    jC, jS, jM = pallas_mel._constants(jmel.MelFrontendParams(
        sample_rate=params.sample_rate, win_length=params.win_length, hop_length=params.hop_length,
        n_mels=params.n_mels, f_min=params.f_min, f_max=params.f_max))
    k = params.n_freqs
    for ours, theirs in ((C, jC), (S, jS)):
        theirs = torch.from_numpy(np.asarray(theirs, dtype=np.float32))
        assert torch.equal(ours.float()[:, :k], theirs[:, :k])
        assert (ours.float()[:, k:] == 0).all() and (theirs[:, k:] == 0).all()
        assert ours.shape[1] % 8 == 0  # the kernel's TMA rows are 16-byte multiples
    np.testing.assert_array_equal(M.numpy()[:k], np.asarray(jM)[:k])


def test_shipped_configs_were_found():
    assert len(SHIPPED) >= 5 and len(ALL_PARAMS) >= 3
