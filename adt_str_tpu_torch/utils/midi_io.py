"""Minimal Standard MIDI File (SMF) reader and writer.

Port of `adt_str_tpu/utils/midi_io.py` (its own copy):

- `read_midi`: parse format 0/1 files -> per-instrument note lists with
  absolute onset seconds (tempo-map aware), drum flag (channel 10), and
  program numbers, as pretty_midi does; the Lakh parser (`data/lakh.py`)
  reads its files with it.
- `write_midi`: write a single-track file from [onset, offset, pitch,
  velocity] rows (drum channel), for the server's `format=midi` answers and
  the transcription CLI.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

DRUM_CHANNEL = 9


@dataclass
class MidiInstrument:
    program: int
    is_drum: bool
    # rows [onset_sec, offset_sec, pitch, velocity]
    notes: list[list[float]] = field(default_factory=list)


def _read_varlen(data: bytes, pos: int) -> tuple[int, int]:
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            return value, pos


def _write_varlen(value: int) -> bytes:
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(out))


def _parse_track(data: bytes) -> list[tuple[int, int, int, int, int]]:
    """-> [(tick, kind, channel, a, b)]; kind 0x8/0x9 notes, -1 tempo (a=µs/qn)."""
    events = []
    pos = 0
    tick = 0
    running = 0
    while pos < len(data):
        delta, pos = _read_varlen(data, pos)
        tick += delta
        status = data[pos]
        if status & 0x80:
            pos += 1
            if status < 0xF0:
                running = status
        else:
            status = running
        if status == 0xFF:  # meta
            meta_type = data[pos]
            pos += 1
            length, pos = _read_varlen(data, pos)
            if meta_type == 0x51 and length == 3:
                tempo = (data[pos] << 16) | (data[pos + 1] << 8) | data[pos + 2]
                events.append((tick, -1, 0, tempo, 0))
            pos += length
        elif status in (0xF0, 0xF7):  # sysex
            length, pos = _read_varlen(data, pos)
            pos += length
        else:
            kind = status >> 4
            channel = status & 0x0F
            if kind in (0x8, 0x9, 0xA, 0xB, 0xE):
                a, b = data[pos], data[pos + 1]
                pos += 2
                if kind in (0x8, 0x9):
                    events.append((tick, kind, channel, a, b))
                elif kind == 0xB:
                    events.append((tick, 0xB, channel, a, b))
            elif kind in (0xC, 0xD):
                a = data[pos]
                pos += 1
                if kind == 0xC:
                    events.append((tick, 0xC, channel, a, 0))
            else:
                raise ValueError(f"bad MIDI status byte {status:#x}")
    return events


def read_midi(path: str | Path) -> list[MidiInstrument]:
    """Parse an SMF file into per-(track, channel, program) instruments."""
    raw = Path(path).read_bytes()
    if raw[:4] != b"MThd":
        raise ValueError("not a MIDI file")
    header_len = struct.unpack(">I", raw[4:8])[0]
    fmt, n_tracks, division = struct.unpack(">HHH", raw[8:14])
    if division & 0x8000:
        raise ValueError("SMPTE time division not supported")
    ticks_per_beat = division

    pos = 8 + header_len
    tracks = []
    for _ in range(n_tracks):
        if raw[pos : pos + 4] != b"MTrk":
            raise ValueError("bad track chunk")
        length = struct.unpack(">I", raw[pos + 4 : pos + 8])[0]
        tracks.append(_parse_track(raw[pos + 8 : pos + 8 + length]))
        pos += 8 + length

    # global tempo map (tick -> µs/qn), default 500000 (120 bpm)
    tempo_events = sorted(
        [(t, a) for track in tracks for (t, kind, _, a, _) in track if kind == -1]
    )
    if not tempo_events or tempo_events[0][0] > 0:
        tempo_events.insert(0, (0, 500000))

    # prefix integral: seconds at each tempo-change tick
    tempo_ticks = np.array([t for t, _ in tempo_events], dtype=np.float64)
    tempo_us = np.array([u for _, u in tempo_events], dtype=np.float64)
    seconds_at = np.zeros(len(tempo_events))
    for i in range(1, len(tempo_events)):
        seconds_at[i] = seconds_at[i - 1] + (
            (tempo_ticks[i] - tempo_ticks[i - 1]) * tempo_us[i - 1] / 1e6 / ticks_per_beat
        )

    def tick_to_sec(tick: int) -> float:
        i = int(np.searchsorted(tempo_ticks, tick, side="right") - 1)
        return float(
            seconds_at[i] + (tick - tempo_ticks[i]) * tempo_us[i] / 1e6 / ticks_per_beat
        )

    instruments: dict[tuple[int, int, int], MidiInstrument] = {}
    for ti, track in enumerate(tracks):
        program_by_channel = dict.fromkeys(range(16), 0)
        # pretty_midi semantics: multiple overlapping note-ons of the same
        # (channel, pitch) all stay open, and ONE note-off closes every open
        # note except those starting exactly at the off tick (a dict of
        # single slots would overwrite earlier note-ons and silently drop
        # drum hits from dense Lakh tracks)
        open_notes: dict[tuple[int, int], list[tuple[int, int]]] = {}
        for tick, kind, channel, a, b in sorted(track, key=lambda e: e[0]):
            if kind == 0xC:
                program_by_channel[channel] = a
            elif kind == 0x9 and b > 0:
                open_notes.setdefault((channel, a), []).append((tick, b))
            elif kind == 0x8 or (kind == 0x9 and b == 0):
                stack = open_notes.get((channel, a))
                if not stack:
                    continue
                closing = [s for s in stack if s[0] != tick]
                if not closing:
                    # pretty_midi: when every open note starts exactly at the
                    # off tick, the key is DELETED — zero-length hits are
                    # discarded, not left open for a later off to materialize
                    del open_notes[(channel, a)]
                    continue
                stack[:] = [s for s in stack if s[0] == tick]
                key = (ti, channel, program_by_channel[channel])
                inst = instruments.setdefault(
                    key,
                    MidiInstrument(
                        program=program_by_channel[channel],
                        is_drum=channel == DRUM_CHANNEL,
                    ),
                )
                end_sec = tick_to_sec(tick)
                for start_tick, velocity in closing:
                    inst.notes.append(
                        [tick_to_sec(start_tick), end_sec, float(a), float(velocity)]
                    )
    return list(instruments.values())


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

    events: list[tuple[int, int, int, int]] = []  # (tick, order, status, (pitch, vel))
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
