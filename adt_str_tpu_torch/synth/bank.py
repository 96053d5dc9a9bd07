"""One-shot drum sample bank: HDF5 library -> padded arrays.

Port of `adt_str_tpu/synth/bank.py` (its own copy; numpy only, like the
original). The library (layout `/<gm-pitch>/<bin>/<name>`; bins `gold,
100-90, ..., 10-0`) is loaded once into a padded `(n_samples, max_len)`
float32 waveform matrix plus dense `(128, n_bins)` offset/count tables, so
timbre sampling and rendering run on the device with fixed shapes
(`synth/render.py:SynthStatics.from_bank`).

Similarity-threshold bin selection: thresholds are floored to a tenth and
all bins from `gold` down to that tenth are eligible; the random choice is
uniform over *eligible bins that exist for the pitch*, then uniform over
that bin's timbres (`synth/render.py:draw_render`). h5py is imported inside
the functions that read or write HDF5: the machine with the card has none.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

BIN_NAMES = [
    "gold",
    "100-90",
    "90-80",
    "80-70",
    "70-60",
    "60-50",
    "50-40",
    "40-30",
    "30-20",
    "20-10",
    "10-0",
]
N_BINS = len(BIN_NAMES)


def floor_to_tenth(x: float) -> float:
    return math.floor(x * 10) / 10


def n_allowed_bins(similarity_threshold: float) -> int:
    """Number of leading bins eligible for a threshold tau (gold counts as 1.0)."""
    floor = floor_to_tenth(similarity_threshold)
    return int(round((1.0 - floor) / 0.1)) + 1


class OneShotBank(NamedTuple):
    """Device-friendly bank. Rows are grouped by (pitch, bin)."""

    waveforms: np.ndarray  # (N, L) float32, zero-padded
    lengths: np.ndarray  # (N,) int32 true sample lengths
    bin_offset: np.ndarray  # (128, N_BINS) int32 first row of (pitch, bin)
    bin_count: np.ndarray  # (128, N_BINS) int32 rows in (pitch, bin)
    max_len: int
    loaded_bins: int = N_BINS  # leading bins materialized (bin-capped load)

    @property
    def n_samples(self) -> int:
        return self.waveforms.shape[0]

    def pitches(self) -> list[int]:
        return sorted(np.where(self.bin_count.sum(axis=1) > 0)[0].tolist())


def build_bank(
    entries: dict[int, dict[str, list[np.ndarray]]],
    max_len: int,
    n_allowed_bins: int | None = None,
) -> OneShotBank:
    """entries: {pitch: {bin_name: [waveform, ...]}} -> OneShotBank.

    `n_allowed_bins` keeps only the leading eligible bins (bank capacity
    story, see `SynthStatics.from_bank`): rows in later bins can never be
    sampled when the render's `similarity_threshold` allows at most that many
    bins, so dropping them is EXACT — eligible rows keep their relative order
    within each (pitch, bin) group, and `draw_render` draws the same
    waveform from the same random numbers (row *indices* shift; row *contents* do not).
    """
    keep = N_BINS if n_allowed_bins is None else max(1, min(n_allowed_bins, N_BINS))
    rows: list[np.ndarray] = []
    lengths: list[int] = []
    bin_offset = np.zeros((128, N_BINS), dtype=np.int32)
    bin_count = np.zeros((128, N_BINS), dtype=np.int32)
    for pitch in sorted(entries):
        for b, bin_name in enumerate(BIN_NAMES[:keep]):
            waves = entries[pitch].get(bin_name, [])
            bin_offset[pitch, b] = len(rows)
            bin_count[pitch, b] = len(waves)
            for w in waves:
                w = np.asarray(w, dtype=np.float32).reshape(-1)[:max_len]
                lengths.append(len(w))
                rows.append(np.pad(w, (0, max_len - len(w))))
    if not rows:
        raise ValueError("empty one-shot bank")
    return OneShotBank(
        waveforms=np.stack(rows),
        lengths=np.asarray(lengths, dtype=np.int32),
        bin_offset=bin_offset,
        bin_count=bin_count,
        max_len=max_len,
        loaded_bins=keep,
    )


def load_bank_hdf5(
    path: str, max_len: int, n_allowed_bins: int | None = None
) -> OneShotBank:
    """Load `<prefix>@<sr>.hdf5` (reference layout) into an OneShotBank.

    `n_allowed_bins` (typically `n_allowed_bins(similarity_threshold)`) skips
    ineligible similarity bins at READ time: their HDF5 datasets are never
    decompressed and their rows never occupy host or device memory. At the
    production threshold 0.8 only 3 of 11 bins load."""
    import h5py

    keep = (
        set(BIN_NAMES)
        if n_allowed_bins is None
        else set(BIN_NAMES[: max(1, min(n_allowed_bins, N_BINS))])
    )
    entries: dict[int, dict[str, list[np.ndarray]]] = {}
    with h5py.File(path, "r") as f:
        for key in f.keys():
            if key == "index":
                continue
            try:
                pitch = int(key)
            except ValueError:
                continue
            group = f[key]
            bins: dict[str, list[np.ndarray]] = {}
            for bin_name in group.keys():
                if bin_name not in keep:
                    continue
                bins[bin_name] = [group[bin_name][name][...] for name in group[bin_name]]
            entries[pitch] = bins
    return build_bank(entries, max_len, n_allowed_bins=n_allowed_bins)


def save_bank_hdf5(path: str, entries: dict[int, dict[str, list[np.ndarray]]], sample_rate: int) -> None:
    """Write the reference HDF5 layout (for tests and for `hdf5_pack` CLI)."""
    import h5py

    with h5py.File(path, "w") as f:
        for pitch, bins in entries.items():
            for bin_name, waves in bins.items():
                for i, w in enumerate(waves):
                    ds = f.create_dataset(
                        f"{pitch}/{bin_name}/sample_{i:04d}",
                        data=np.asarray(w, dtype=np.float32),
                        compression="gzip",
                    )
                    ds.attrs["sample_rate"] = sample_rate


def make_test_bank(
    rng: np.random.Generator,
    pitches: list[int],
    sample_rate: int = 24000,
    max_len: int | None = None,
    n_per_bin: int = 2,
    bins: list[str] = ("gold", "100-90", "90-80"),
) -> OneShotBank:
    """Synthetic bank of exponentially-decaying noise bursts (test fixture)."""
    max_len = max_len or sample_rate // 2
    entries: dict[int, dict[str, list[np.ndarray]]] = {}
    for pitch in pitches:
        entries[pitch] = {}
        for bin_name in bins:
            waves = []
            for _ in range(n_per_bin):
                n = int(rng.integers(max_len // 4, max_len))
                t = np.arange(n) / sample_rate
                freq = 60 + 40 * (pitch - 35)
                w = np.exp(-t * rng.uniform(5, 30)) * (
                    0.7 * np.sin(2 * np.pi * freq * t)
                    + 0.3 * rng.normal(size=n)
                )
                waves.append(w.astype(np.float32))
            entries[pitch][bin_name] = waves
    return build_bank(entries, max_len)
