"""MIDI utility predicates. Port of `adt_str_tpu/utils/midi_utils.py` (its own copy)."""

from __future__ import annotations


class MidiUtils:
    def _program_to_group(self, program: int) -> str:
        """GM program number -> instrument group (utils/midi_utils.py:5-29).

        Preserves the reference's overlapping-range quirks (e.g. program 56 hits
        the `string` branch before `brass`; 80-104 `synth` shadows 104-111
        `guitar` for 104)."""
        if program <= 7:
            return "keyboard"
        if 8 <= program <= 15:
            return "mallet"
        if 16 <= program <= 23:
            return "organ"
        if 24 <= program <= 31 or 104 <= program <= 111:
            return "guitar"
        if 32 <= program <= 39:
            return "bass"
        if 40 <= program <= 52 or program == 56:
            return "string"
        if 56 <= program <= 63:
            return "brass"
        if 64 <= program <= 71:
            return "reed"
        if 72 <= program <= 79:
            return "flute"
        if 80 <= program <= 104:
            return "synth"
        if program in [53, 54, 55, 86]:
            return "vocal"
        return "other"

    def valid_note_per_instrument(self, instrument: str, pitch: int) -> bool:
        """Drums: valid GM percussion pitch range 35-81 (utils/midi_utils.py:31-64)."""
        if instrument == "drums":
            return 35 <= pitch <= 81
        if instrument in {
            "keyboard", "mallet", "organ", "guitar", "bass", "string",
            "brass", "reed", "flute", "synth", "vocal",
        }:
            raise NotImplementedError(f"{instrument} is not supported yet")
        return False

    def invalid_drum_note(self, pitch: int, onset: float, offset: float) -> bool:
        return pitch > 81 or pitch < 35 or onset >= offset

    def invalid_instrument_note(self, pitch: int, onset: float, offset: float) -> bool:
        return pitch > 127 or pitch < 0 or onset >= offset

    def offset_length_check(self, onset: float, offset: float) -> float:
        if offset - onset < 0.01:
            offset += 0.01
        return offset
