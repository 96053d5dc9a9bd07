"""On-device drum synthesis: note lists -> audio.

Port of `adt_str_tpu/synth/render.py` (its own copy): a segment's notes are
grouped into the 27 drum-pitch slots (35..61); each slot gets a main and a
sub timbre (bank rows) and a mixup weight, the blend `(1-l)*main + l*sub` is
peak-normalised, every note places its slot's blend at its onset scaled by
the velocity curve `vel_to_vol` and the class gain (HH, cymbals and
auxiliary percussion 0.7), an FX chain runs with probability `use_fx_prob`,
and the segment is peak-normalised to the master gain `vel_to_vol(max
velocity)`. One-shots that run past the segment are clipped.

Drawing is split from computing: torch cannot reproduce `jax.random`
streams, so `draw_render` draws a `RenderDraws` (timbre rows, mixup
weights, FX choices and parameters) from a `torch.Generator`, and
`render_batch_arrays` computes the audio from it deterministically, step for
step as the JAX package's TPU path does:

1. `blend_notes`: K2 (`ops/cuda_place.py:gather_blend`) blends the slots'
   rows in f32 and stores the bank's dtype; the f32 peak of each blend is
   folded into the per-note gains, and slots whose draw found no eligible
   bank bin are silenced;
2. `place_blend`: K3 (`ops/cuda_place.py:place_notes`) adds the notes,
   streaming the blend rows in bf16 on CUDA (the statics' dtype on the CPU);
3. `apply_fx`: the FX chain on a compacted budget of rows (mean + 6 sigma
   of Binomial(B, p)); rows beyond the budget skip FX;
4. `normalise`: master gain, and silence for rows without notes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from adt_str_tpu_torch import resolve_device
from adt_str_tpu_torch.config import SynthConfig
from adt_str_tpu_torch.ops import cuda_place
from adt_str_tpu_torch.synth.bank import N_BINS, OneShotBank, n_allowed_bins
from adt_str_tpu_torch.synth.fx import FxParams, draw_fx_params, fx_chain
from adt_str_tpu_torch.utils.mappings import ADTOF_INVERSE_MAPPING, ADTOF_LABEL_MAPPING, ADTOF_LUT

# valid synthesis pitch range
PITCH_LO, PITCH_HI = 35, 61
N_SLOTS = PITCH_HI - PITCH_LO + 1  # 27 instrument slots

# per-ADTOF-class mix gains (the reference's VolumeMixer)
_CLASS_GAIN = {
    "BD": 1.0,
    "SD": 1.0,
    "TT": 1.0,
    "HH": 0.7,
    "CY + RD": 0.7,
    "Cowbell": 0.7,
    "Claves": 0.7,
    "Other": 1.0,
}


def class_gain_lut() -> np.ndarray:
    """(128,) per-pitch mix gain: pitch -> ADTOF class -> gain."""
    lut = np.ones(128, dtype=np.float32)
    for pitch in range(128):
        adtof = ADTOF_LUT[pitch]
        if adtof >= 0:
            lut[pitch] = _CLASS_GAIN[ADTOF_LABEL_MAPPING[int(adtof)]]
    return lut


def adtof_member_tables() -> tuple[np.ndarray, np.ndarray]:
    """(128, 8) member-pitch table + (128,) counts for the ADTOF inverse map
    (the timbre draw picks a random member pitch first). Identity (count 1)
    for non-ADTOF pitches."""
    table = np.tile(np.arange(128, dtype=np.int32)[:, None], (1, 8))
    counts = np.ones(128, dtype=np.int32)
    for cls, members in ADTOF_INVERSE_MAPPING.items():
        table[cls, : len(members)] = members
        counts[cls] = len(members)
    return table, counts


class SynthStatics(NamedTuple):
    """Device-resident constants for rendering (bank + lookup tables)."""

    waveforms: torch.Tensor  # (N, L)
    bin_offset: torch.Tensor  # (128, N_BINS) int64
    bin_count: torch.Tensor  # (128, N_BINS) int64
    class_gain: torch.Tensor  # (128,) f32
    member_table: torch.Tensor  # (128, 8) int64
    member_count: torch.Tensor  # (128,) int64
    # leading bins materialized by the (possibly bin-capped) bank load: a
    # render whose similarity_threshold needs more bins than were loaded
    # would silently sample empty bins, so `render_batch` and the step
    # factory check it (`check_bins_loaded`)
    loaded_bins: int = N_BINS

    @classmethod
    def from_bank(cls, bank: OneShotBank, dtype=None, hbm_limit_gib: float = 12.0, device=None) -> "SynthStatics":
        """The bank on `device` (None: cuda), in bf16 on CUDA and f32 on the
        CPU unless `dtype` says otherwise: bf16 halves the gather traffic, and
        a 100k-one-shot bank at 1.28 s / 24 kHz is ~6 GB in bf16. bf16 sits
        ~-45 dB below each one-shot's peak, inaudible for augmentation.
        `bank.waveforms` may be a numpy array or a tensor already on the
        device. A bank above `hbm_limit_gib` raises with the remediations."""
        device = resolve_device(device)
        if dtype is None:
            dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        rows, length = bank.waveforms.shape
        gib = rows * length * dtype.itemsize / float(1 << 30)
        if gib > hbm_limit_gib:
            raise ValueError(
                f"one-shot bank is {gib:.1f} GiB in {str(dtype).removeprefix('torch.')} "
                f"({rows} rows x {length} samples) — over the {hbm_limit_gib:.1f} GiB device budget. "
                "Remediations, in order: load only the eligible similarity "
                "bins (load_bank_hdf5(..., n_allowed_bins=n_allowed_bins("
                "similarity_threshold)) — exact, the trainer does this "
                "automatically); raise similarity_threshold (fewer bins); "
                "lower max_oneshot_sec (shorter rows); or raise "
                "hbm_limit_gib if the device actually has the headroom."
            )
        table, counts = adtof_member_tables()

        def _long(a) -> torch.Tensor:
            return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)

        return cls(
            waveforms=torch.as_tensor(bank.waveforms, device=device).to(dtype).contiguous(),
            bin_offset=_long(bank.bin_offset),
            bin_count=_long(bank.bin_count),
            class_gain=torch.as_tensor(class_gain_lut(), device=device),
            member_table=_long(table),
            member_count=_long(counts),
            loaded_bins=int(bank.loaded_bins),
        )


def check_bins_loaded(statics: SynthStatics, similarity_threshold: float) -> None:
    """Raise when a render's threshold needs more similarity bins than the
    bank load materialized (`load_bank_hdf5(n_allowed_bins=...)`) — sampling
    past the cap would silently draw empty bins (silence) where the full bank
    has one-shots."""
    need = n_allowed_bins(similarity_threshold)
    if need > int(statics.loaded_bins):
        raise ValueError(
            f"similarity_threshold={similarity_threshold} samples {need} "
            f"bins but the bank was loaded with only the leading {int(statics.loaded_bins)} "
            "(load_bank_hdf5(n_allowed_bins=...)); reload the bank with "
            f"n_allowed_bins>={need} or raise the threshold"
        )


def vel_to_vol(velocity: torch.Tensor) -> torch.Tensor:
    """Exponential velocity -> gain curve (the reference's `_vel_to_vol`:
    base 6, from 0.1 at velocity 0+ to 1.0 at 127; 0 for velocity 0)."""
    v = torch.clamp(velocity, 0.0, 127.0) / 127.0
    vol = 0.1 + (1.0 - 0.1) * (torch.pow(6.0, v) - 1.0) / (6.0 - 1.0)
    return torch.where(velocity == 0, 0.0, vol)


class RenderDraws(NamedTuple):
    """Everything random in a render of B segments."""

    main_rows: torch.Tensor  # (B, N_SLOTS) int64 bank row of each slot's main timbre
    sub_rows: torch.Tensor  # (B, N_SLOTS) int64 bank row of its sub timbre
    slot_ok: torch.Tensor  # (B, N_SLOTS) bool: both draws found an eligible bin
    lam: torch.Tensor  # (B, N_SLOTS) f32 mixup weights in [0, mixup_range)
    use_fx: torch.Tensor  # (B,) bool
    fx: FxParams  # (B,) each


def _randint_below(high: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """A uniform integer in [0, high) for each element of `high` (>= 1)."""
    u = torch.rand(high.shape, generator=generator, dtype=torch.float64, device=high.device)
    return torch.minimum((u * high).long(), high - 1)


def _sample_timbre_rows(statics: SynthStatics, batch: int, generator: torch.Generator, n_allowed: int,
                        adtof: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, N_SLOTS) bank rows + (B, N_SLOTS) validity (False where the
    pitch has no eligible bin; the render silences such slots). The choices
    follow the reference: [ADTOF member pitch] -> an eligible bin that
    exists for the pitch, uniformly -> a timbre within the bin, uniformly."""
    sl = slice(PITCH_LO, PITCH_HI + 1)
    if adtof:
        m = _randint_below(torch.clamp_min(statics.member_count[sl], 1).expand(batch, N_SLOTS), generator)
        member = statics.member_table[sl].expand(batch, N_SLOTS, -1)
        pitches = torch.gather(member, 2, m[..., None])[..., 0]
        counts, offsets = statics.bin_count[pitches], statics.bin_offset[pitches]
    else:
        counts = statics.bin_count[sl].expand(batch, N_SLOTS, N_BINS)
        offsets = statics.bin_offset[sl].expand(batch, N_SLOTS, N_BINS)
    bins = torch.arange(N_BINS, device=counts.device)
    eligible = (bins < n_allowed) & (counts > 0)
    n_eligible = eligible.sum(-1)
    r = _randint_below(torch.clamp_min(n_eligible, 1), generator)
    sel = (torch.cumsum(eligible.long(), -1) == (r + 1)[..., None]) & eligible  # the (r+1)-th eligible bin
    cnt = (counts * sel).sum(-1)
    off = (offsets * sel).sum(-1)
    t = _randint_below(torch.clamp_min(cnt, 1), generator)
    return off + t, n_eligible > 0


def draw_render(statics: SynthStatics, batch: int, synth_config: SynthConfig,
                generator: torch.Generator) -> RenderDraws:
    """The draws of a render of `batch` segments, from `generator` (on the
    statics' device)."""
    cfg = synth_config
    n_allowed = n_allowed_bins(cfg.similarity_threshold)
    main_rows, main_ok = _sample_timbre_rows(statics, batch, generator, n_allowed, cfg.ADTOF_mapping)
    sub_rows, sub_ok = _sample_timbre_rows(statics, batch, generator, n_allowed, cfg.ADTOF_mapping)
    dev = statics.waveforms.device
    lam = torch.rand(batch, N_SLOTS, generator=generator, device=dev) * cfg.mixup_range
    use_fx = torch.rand(batch, generator=generator, device=dev) < cfg.use_fx_prob
    fx = draw_fx_params(batch, generator, cfg.use_reverb_prob, cfg.use_compression_prob, cfg.use_limiter_prob)
    return RenderDraws(main_rows, sub_rows, main_ok & sub_ok, lam, use_fx, fx)


def fx_budget(batch: int, use_fx_prob: float) -> int:
    """Rows that pay the FX chain: mean + 6 sigma of Binomial(B, p), so that
    more FX rows than the budget happen with probability < ~1e-8."""
    p = min(max(float(use_fx_prob), 0.0), 1.0)
    if p <= 0:
        return 0
    return min(batch, int(np.ceil(batch * p + 6.0 * np.sqrt(batch * p * (1.0 - p)))))


def blend_notes(statics: SynthStatics, notes: torch.Tensor, mask: torch.Tensor, draws: RenderDraws,
                chunk_samples: int, sample_rate: int):
    """-> (blend (B, N_SLOTS, L) in the bank's dtype, slot, onset, gain (B, MAX_NOTES)):
    K2's blends, and the per-note gains with each blend's f32 peak folded in
    and slots without an eligible bin silenced. Draws of another batch
    shape raise; row ids outside the bank are clamped into it (K2)."""
    B = notes.shape[0]
    if any(t.shape != (B, N_SLOTS) for t in draws[:4]) or any(t.shape != (B,) for t in (draws.use_fx, *draws.fx)):
        raise ValueError(f"draws for a batch of {B}: main_rows, sub_rows, slot_ok and lam must be (B, {N_SLOTS}), "
                         f"use_fx and the FX parameters (B,); got main_rows {tuple(draws.main_rows.shape)}, "
                         f"use_fx {tuple(draws.use_fx.shape)}")
    table = statics.waveforms
    blend = cuda_place.gather_blend(table, draws.main_rows.reshape(-1), draws.sub_rows.reshape(-1),
                                    draws.lam.reshape(-1)).reshape(B, N_SLOTS, table.shape[1])
    peak = torch.clamp_min(blend.abs().amax(-1).float(), 1e-8)  # (B, N_SLOTS)

    pitch = torch.clamp(notes[..., 2].to(torch.int32), 0, 127).long()
    velocity = notes[..., 3]
    # f32 product truncated toward zero, as the JAX package computes it
    onset = torch.clamp((notes[..., 0] * sample_rate).to(torch.int32), 0, chunk_samples - 1)
    slot = torch.clamp(pitch - PITCH_LO, 0, N_SLOTS - 1)
    gain = vel_to_vol(velocity) * statics.class_gain[pitch]
    gain = torch.where(mask & (pitch >= PITCH_LO) & (pitch <= PITCH_HI), gain, 0.0)
    gain = gain * torch.gather(draws.slot_ok, 1, slot).to(gain.dtype)
    gain = gain / torch.gather(peak, 1, slot)
    return blend, slot, onset, gain


def place_blend(blend: torch.Tensor, slot: torch.Tensor, onset: torch.Tensor, gain: torch.Tensor,
                chunk_samples: int) -> torch.Tensor:
    """(B, chunk_samples) f32 audio through K3; the blend rows stream in
    bf16 on CUDA and in their own dtype on the CPU."""
    stream = blend.to(torch.bfloat16) if blend.device.type == "cuda" else blend
    return cuda_place.place_notes(stream, slot, onset, gain, chunk_samples)


def apply_fx(wav: torch.Tensor, draws: RenderDraws, sample_rate: int, use_fx_prob: float) -> torch.Tensor:
    """The FX chain on rows that drew it. The rows are compacted into a
    budget of `fx_budget` rows (FX rows first, stable order); with a budget
    of the whole batch, or B <= 8, every row runs the chain."""
    B = wav.shape[0]
    if use_fx_prob <= 0.0:
        return wav  # chain disabled: no row can draw it
    budget = fx_budget(B, use_fx_prob)
    if budget >= B or B <= 8:
        return torch.where(draws.use_fx[:, None], fx_chain(wav, sample_rate, draws.fx), wav)
    order = torch.argsort((~draws.use_fx).to(torch.int8), stable=True)  # fx rows first
    idx = order[:budget]
    sub = wav[idx]
    sub = torch.where(draws.use_fx[idx][:, None], fx_chain(sub, sample_rate, draws.fx.take(idx)), sub)
    return wav.index_copy(0, idx, sub)


def normalise(wav: torch.Tensor, notes: torch.Tensor, mask: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """Peak-normalise each row to the master gain vel_to_vol(max velocity);
    rows without a sounding note stay silent."""
    max_vel = torch.where(mask, notes[..., 3], 0.0).amax(1)
    master = vel_to_vol(max_vel)
    wav = wav / torch.clamp_min(wav.abs().amax(1, keepdim=True), 1e-8)
    wav = wav * master[:, None]
    any_notes = (mask & (gain > 0)).any(1)
    return torch.where(any_notes[:, None], wav, 0.0)


def render_batch_arrays(statics: SynthStatics, notes: torch.Tensor, mask: torch.Tensor, draws: RenderDraws,
                        chunk_samples: int, sample_rate: int, use_fx_prob: float = 0.3) -> torch.Tensor:
    """(B, MAX_NOTES, 4) [onset s, offset s, pitch, velocity] notes and their
    (B, MAX_NOTES) mask -> (B, chunk_samples) f32 audio on the statics'
    device, deterministic given `draws` (see the module docstring)."""
    dev = statics.waveforms.device
    notes = notes.to(dev, torch.float32)
    mask = mask.to(dev, torch.bool)
    blend, slot, onset, gain = blend_notes(statics, notes, mask, draws, chunk_samples, sample_rate)
    wav = place_blend(blend, slot, onset, gain, chunk_samples)
    del blend
    wav = apply_fx(wav, draws, sample_rate, use_fx_prob)
    return normalise(wav, notes, mask, gain)


def render_batch(statics: SynthStatics, notes: torch.Tensor, mask: torch.Tensor, draws: RenderDraws,
                 config: SynthConfig) -> torch.Tensor:
    """(B, chunk_samples) batch synthesis driven by a SynthConfig."""
    check_bins_loaded(statics, config.similarity_threshold)
    return render_batch_arrays(statics, notes, mask, draws, chunk_samples=config.chunk_samples,
                               sample_rate=config.sample_rate, use_fx_prob=config.use_fx_prob)


def render_segment(statics: SynthStatics, notes: torch.Tensor, mask: torch.Tensor, draws: RenderDraws,
                   chunk_samples: int, sample_rate: int, **kwargs) -> torch.Tensor:
    """One segment: (MAX_NOTES, 4) notes and their (MAX_NOTES,) mask, with
    the `draws` of a batch of one -> (chunk_samples,) f32 audio; a wrapper
    over `render_batch_arrays` (`adt_str_tpu/synth/render.py:render_segment`)."""
    return render_batch_arrays(statics, notes[None], mask[None], draws, chunk_samples=chunk_samples,
                               sample_rate=sample_rate, **kwargs)[0]


def pad_notes(notes: np.ndarray, max_notes: int) -> tuple[np.ndarray, np.ndarray]:
    """Host helper: (n, 4) float notes -> fixed (max_notes, 4) + bool mask.

    Invalid rows (pitch outside 35..61 or offset < onset) raise, matching the
    reference `_valid_note` assertion.
    """
    notes = np.asarray(notes, dtype=np.float32).reshape(-1, 4)
    if len(notes):
        valid = (
            (notes[:, 2] >= PITCH_LO)
            & (notes[:, 2] <= PITCH_HI)
            & (notes[:, 1] >= notes[:, 0])
        )
        if not valid.all():
            raise ValueError(f"Invalid note rows: {notes[~valid]}")
    n = min(len(notes), max_notes)
    out = np.zeros((max_notes, 4), dtype=np.float32)
    out[:n] = notes[:n]
    mask = np.zeros(max_notes, dtype=bool)
    mask[:n] = True
    return out, mask
