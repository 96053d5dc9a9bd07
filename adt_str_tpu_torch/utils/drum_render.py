"""Drum preview: MIDI export and additive one-shot rendering on the host.

Port of `adt_str_tpu/utils/drum_render.py` (host numpy, as there): notes
render additively from a `<bank_dir>/<pitch>/*.wav` bank (the first WAV of
a pitch, resampled and cached); a note whose pitch has no sample is
silent; velocity maps linearly to gain; the mix is peak-limited to 0.98.
The MIDI goes through the port's SMF writer (`utils/midi_io.py`). The
same files and notes give the same samples and bytes as the JAX package.
"""

from __future__ import annotations

import glob
import logging
import os
from pathlib import Path
from typing import Optional

import numpy as np

from adt_str_tpu_torch.utils.audio_io import load_and_resample
from adt_str_tpu_torch.utils.mappings import GM_STANDARD_TO_GM_CUSTOM_LUT
from adt_str_tpu_torch.utils.midi_io import write_midi

DEFAULT_BANK_DIR = "one-shot-rendering"

_oneshot_cache: dict[tuple[str, int, int], Optional[np.ndarray]] = {}


def velocity_to_midi(vel: float) -> int:
    """A velocity <= 1.0 is normalised (times 127), else already MIDI; rounded and clipped to 1-127."""
    v = float(vel)
    v = round(v * 127) if v <= 1.0 else round(v)
    return int(np.clip(v, 1, 127))


def save_drum_midi(notes: np.ndarray, midi_path: str | Path) -> None:
    """Drum-channel MIDI of [onset, offset, pitch, velocity] rows; a note
    whose offset is not after its onset lasts 50 ms."""
    notes = np.asarray(notes, dtype=np.float64).reshape(-1, 4).copy()
    bad = notes[:, 1] <= notes[:, 0]
    notes[bad, 1] = notes[bad, 0] + 0.05
    notes[:, 3] = [velocity_to_midi(v) for v in notes[:, 3]]
    write_midi(midi_path, notes, is_drum=True)


def get_oneshot_waveform(pitch: int, sample_rate: int, bank_dir: str = DEFAULT_BANK_DIR) -> Optional[np.ndarray]:
    """The first WAV under `<bank_dir>/<pitch>/`, resampled to
    `sample_rate` and cached; None when there is none. A load that fails is
    logged and not cached."""
    key = (bank_dir, int(pitch), sample_rate)
    if key in _oneshot_cache:
        return _oneshot_cache[key]
    wavs = sorted(glob.glob(os.path.join(bank_dir, str(int(pitch)), "*.wav")))
    wave = None
    if wavs:
        try:
            wave = load_and_resample(wavs[0], sample_rate).astype(np.float32)
        except Exception as e:  # noqa: BLE001 (a transient failure must not mute the pitch for the process)
            logging.getLogger(__name__).warning("one-shot load failed %s: %s", wavs[0], e)
            return None
    _oneshot_cache[key] = wave
    return wave


def synthesize_drums_procedural(notes: np.ndarray, num_samples: int, sample_rate: int,
                                bank_dir: str = DEFAULT_BANK_DIR, apply_mapping: bool = False) -> np.ndarray:
    """Additive one-shot rendering -> (num_samples,) float32, peak-limited to 0.98."""
    buf = np.zeros(num_samples, dtype=np.float32)
    notes = np.asarray(notes, dtype=np.float64).reshape(-1, 4)
    for onset, _, pitch, vel in notes:
        pitch = int(pitch)
        if apply_mapping and 0 <= pitch < 128 and GM_STANDARD_TO_GM_CUSTOM_LUT[pitch] >= 0:
            pitch = int(GM_STANDARD_TO_GM_CUSTOM_LUT[pitch])
        shot = get_oneshot_waveform(pitch, sample_rate, bank_dir)
        if shot is None:
            continue
        start = int(round(onset * sample_rate))
        if start >= num_samples or start < 0:
            continue
        gain = velocity_to_midi(vel) / 127.0
        seg = shot[: num_samples - start]
        buf[start : start + len(seg)] += seg * gain
    peak = np.abs(buf).max()
    if peak > 1e-6:
        buf *= min(1.0, 0.98 / peak)
    return buf


def render_drum_preview(notes: np.ndarray, num_samples: int, sample_rate: int,
                        midi_path: Optional[str | Path] = None, bank_dir: str = DEFAULT_BANK_DIR,
                        apply_mapping: bool = False) -> tuple[np.ndarray, str]:
    """Write the MIDI when `midi_path` is given; -> (the preview audio, "oneshot")."""
    if midi_path is not None:
        save_drum_midi(notes, midi_path)
    return synthesize_drums_procedural(notes, num_samples, sample_rate, bank_dir, apply_mapping), "oneshot"
