"""Minimal Standard MIDI File writer for the server's `format=midi` answers.

Port of `adt_str_tpu/utils/midi_io.py:write_midi` (its own copy; the reader
joins when a data slice needs it).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

DRUM_CHANNEL = 9


def _write_varlen(value: int) -> bytes:
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(out))


def write_midi(
    path: str | Path,
    notes: np.ndarray,
    is_drum: bool = True,
    program: int = 0,
    tempo_bpm: float = 120.0,
    ticks_per_beat: int = 480,
) -> None:
    """[onset, offset, pitch, velocity] rows -> single-track SMF."""
    notes = np.asarray(notes, dtype=np.float64).reshape(-1, 4)
    channel = DRUM_CHANNEL if is_drum else 0
    sec_per_tick = 60.0 / tempo_bpm / ticks_per_beat

    events: list[tuple[int, int, int, tuple[int, int]]] = []  # (tick, order, status, (pitch, vel))
    for onset, offset, pitch, velocity in notes:
        p = int(np.clip(pitch, 0, 127))
        v = int(np.clip(velocity, 0, 127))
        on_tick = int(round(onset / sec_per_tick))
        off_tick = max(on_tick + 1, int(round(offset / sec_per_tick)))
        events.append((on_tick, 1, 0x90 | channel, (p, max(v, 1))))
        events.append((off_tick, 0, 0x80 | channel, (p, 0)))
    events.sort(key=lambda e: (e[0], e[1]))

    tempo_us = int(round(60_000_000 / tempo_bpm))
    body = bytearray()
    body += _write_varlen(0) + bytes([0xFF, 0x51, 0x03]) + tempo_us.to_bytes(3, "big")
    if not is_drum:
        body += _write_varlen(0) + bytes([0xC0 | channel, program])
    prev = 0
    for tick, _, status, (p, v) in events:
        body += _write_varlen(tick - prev) + bytes([status, p, v])
        prev = tick
    body += _write_varlen(0) + bytes([0xFF, 0x2F, 0x00])

    with open(path, "wb") as f:
        f.write(b"MThd" + struct.pack(">IHHH", 6, 0, 1, ticks_per_beat))
        f.write(b"MTrk" + struct.pack(">I", len(body)) + bytes(body))
