"""The one general traffic generator. A mix is a data file beside this one,
`<mix>.json`, whose `kind` names the generator below that reads it and
whose other keys are its parameters. Everything is drawn from the run's
seed, so the same seed gives the same inputs, and every seed gives the same
sizes (note counts, song lengths) in another order, so the work does not
follow the seed.

- `synth_notes`: training batches of drum note lists over the synthesiser's
  pitches, their token rows ([BOS, (time, pitch, velocity)*, EOS], padded),
  the render's draws (timbre rows, mixup weights, FX) and the dropout site
  keys of each step;
- `song_backlog`: whole songs of drum-like audio for clients that chunk
  them and keep a backlog of chunks queued: a pool of chunk-long segments
  (noise bursts with exponential decays at random onsets over a quiet
  floor) made at set-up, and each song a seeded run of them, so a client
  makes a song by copying.
"""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
BOS, EOS, PAD = 2, 3, 1
TIME_OFFSET, PITCH_OFFSET, VELOCITY_OFFSET = 4, 300, 400
SYNTH_PITCHES = (35, 61)  # the render's drum-pitch slots, GM pitches as the dataset maps them


def load(name: str) -> dict:
    """The mix `name`'s parameters."""
    return json.loads((HERE / f"{name}.json").read_text())


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, *stream])


# ------------------------------------------------------------ training


def note_counts(mix: dict, batch: int) -> np.ndarray:
    """Each row's note count: the same spread every step and seed."""
    return np.round(np.linspace(mix["notes_min"], mix["notes_max"], batch)).astype(np.int64)


def tokens_of(notes: np.ndarray) -> np.ndarray:
    """[BOS, (time, pitch, velocity)*, EOS] of (n, 4) float32 notes; the
    time token is the float32 product onset * 100 truncated, plus 4."""
    t = np.trunc(notes[:, 0] * np.float32(100.0)).astype(np.int64) + TIME_OFFSET
    body = np.stack([t, notes[:, 2].astype(np.int64) + PITCH_OFFSET,
                     notes[:, 3].astype(np.int64) + VELOCITY_OFFSET], axis=1).reshape(-1)
    return np.concatenate([[BOS], body, [EOS]]).astype(np.int64)


def train_batch(mix: dict, seed: int, step: int, batch: int, max_notes: int, max_tokens: int) -> dict:
    """Step `step`'s rows: {"notes" (B, max_notes, 4) f32, "note_mask" (B,
    max_notes), "tokens" (B, max_tokens) int64, "token_lengths" (B,)} as
    numpy, with the collate convention of the reference dataset (lengths
    equal to the batch's longest lose one)."""
    rng = _rng(seed, 1, step)
    counts = rng.permutation(note_counts(mix, batch))
    notes = np.zeros((batch, max_notes, 4), np.float32)
    mask = np.zeros((batch, max_notes), bool)
    tokens = np.full((batch, max_tokens), PAD, np.int64)
    lengths = np.zeros(batch, np.int64)
    lo, hi = mix["velocity"]
    for i, n in enumerate(counts):
        onset = np.sort(rng.uniform(0.0, mix["onset_max_s"], n)).astype(np.float32)
        pitch = rng.integers(SYNTH_PITCHES[0], SYNTH_PITCHES[1] + 1, n).astype(np.float32)
        velocity = rng.integers(lo, hi + 1, n).astype(np.float32)
        notes[i, :n] = np.stack([onset, onset + np.float32(0.1), pitch, velocity], axis=1)
        mask[i, :n] = True
        row = tokens_of(notes[i, :n])
        tokens[i, : len(row)] = row
        lengths[i] = len(row)
    lengths = lengths - (lengths == lengths.max())
    return {"notes": notes, "note_mask": mask, "tokens": tokens, "token_lengths": lengths}


def _clamped_normal(z, std, mean, high, low):
    x = torch.clamp(z * std + mean, -1.0, 1.0)
    return torch.clamp(torch.abs(x) * high, low, high)


def render_draws(gen: torch.Generator, batch: int, n_bins: int, rows_per_bin: int, synth: dict):
    """The render's draws of one step from `gen` (on the device), over a
    bank whose rows run (slot, bin, row) with `n_bins` eligible bins of
    `rows_per_bin` rows for every slot: for each slot a main and a sub bank
    row (a bin uniformly, then a row of it uniformly), mixup weights in [0,
    mixup_range), the FX coin and the FX parameters.
    -> SimpleNamespace(main_rows, sub_rows, slot_ok, lam, use_fx, fx)."""
    dev = gen.device
    n_slots = SYNTH_PITCHES[1] - SYNTH_PITCHES[0] + 1
    base = torch.arange(n_slots, device=dev) * n_bins * rows_per_bin

    def rows() -> torch.Tensor:
        u = torch.rand(2, batch, n_slots, generator=gen, device=dev, dtype=torch.float64)
        b = torch.clamp((u[0] * n_bins).long(), max=n_bins - 1)
        r = torch.clamp((u[1] * rows_per_bin).long(), max=rows_per_bin - 1)
        return base + b * rows_per_bin + r

    main, sub = rows(), rows()
    lam = torch.rand(batch, n_slots, generator=gen, device=dev) * synth["mixup_range"]
    use_fx = torch.rand(batch, generator=gen, device=dev) < synth["use_fx_prob"]
    u = torch.rand(7, batch, generator=gen, device=dev)
    z = torch.randn(5, batch, generator=gen, device=dev)
    fx = dict(use_reverb=u[0] < synth["use_reverb_prob"], use_compression=u[1] < synth["use_compression_prob"],
              use_limiter=u[2] < synth["use_limiter_prob"], room=0.2 + 0.6 * u[3], damping=0.2 + 0.6 * u[4],
              wet=0.1 + 0.3 * u[5], width=0.6 + 0.4 * u[6],
              comp_threshold_db=-_clamped_normal(z[0], 0.15, 0.5, 10.0, 0.0),
              comp_ratio=_clamped_normal(z[1], 0.15, 0.5, 10.0, 1.0),
              comp_attack_ms=_clamped_normal(z[2], 0.05, 0.1, 1000.0, 0.0),
              comp_release_ms=_clamped_normal(z[3], 0.15, 0.2, 1000.0, 0.0),
              lim_threshold_db=-_clamped_normal(z[4], 0.2, 0.4, 3.0, 0.0))
    ok = torch.ones(batch, n_slots, dtype=torch.bool, device=dev)
    return SimpleNamespace(main_rows=main, sub_rows=sub, slot_ok=ok, lam=lam, use_fx=use_fx, fx=fx)


def site_keys(seed: int, step: int, n_sites: int) -> torch.Tensor:
    """(n_sites, 2) int64 tensor of uint32 key words of one step's dropout sites."""
    rng = _rng(seed, 2, step)
    return torch.from_numpy(rng.integers(0, 2**32, (n_sites, 2), dtype=np.int64))


# ------------------------------------------------------------ serving


def song_seconds(mix: dict, seed: int, n: int) -> np.ndarray:
    """n song lengths: an even spread over the mix's range, in the seed's order."""
    lo, hi = mix["song_seconds"]
    return _rng(seed, 3).permutation(np.linspace(lo, hi, n))


def segment_pool(seed: int, n: int, seconds: float, sample_rate: int) -> np.ndarray:
    """(n, seconds * sample_rate) float32 segments of drum-like audio."""
    return np.stack([song_audio(seed, 1_000_000 + i, seconds, sample_rate) for i in range(n)])


def song(pool: np.ndarray, seed: int, index: int, seconds: float, sample_rate: int) -> np.ndarray:
    """Song `index`: `seconds` of audio, a seeded run of the pool's segments."""
    n = int(seconds * sample_rate)
    picks = _rng(seed, 6, index).integers(0, len(pool), -(-n // pool.shape[1]))
    return pool[picks].reshape(-1)[:n]


def song_audio(seed: int, index: int, seconds: float, sample_rate: int) -> np.ndarray:
    """A song of drum-like audio: a quiet noise floor and decaying noise
    bursts at onsets 60-500 ms apart."""
    rng = _rng(seed, 4, index)
    n = int(seconds * sample_rate)
    gaps = rng.integers(int(0.06 * sample_rate), int(0.5 * sample_rate), n // int(0.06 * sample_rate) + 1)
    onsets = np.cumsum(gaps)
    onsets = onsets[onsets < n]
    idx = np.arange(n)
    is_onset = np.zeros(n, bool)
    is_onset[onsets] = True
    last = np.maximum.accumulate(np.where(is_onset, idx, 0))
    level = np.zeros(n, np.float32)
    level[onsets] = rng.uniform(0.2, 0.9, len(onsets))
    env = level[last] * np.exp(-(idx - last) / (0.05 * sample_rate)).astype(np.float32)
    return rng.standard_normal(n, dtype=np.float32) * (env + np.float32(0.01))
