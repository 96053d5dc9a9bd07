"""MIDI token codec and the dataset pitch remap.

Port of `adt_str_tpu/domain/tokenizer.py:MidiTokenizer`: the encode side
(`notes_to_adt_tokens`, `empty_adt_tokens`, the fixed-length
`encode_padded`), the decode side (through the JAX package's pure-Python
decode `_decode_python`) and `map_notes_to_Gm_custom`.

Vocab layout:
  0            silence
  1            PAD
  2            BOS
  3            EOS
  4..299       time tokens  (10 ms grid: token = int(onset*100) + 4)
  300..399     pitch tokens (token = pitch + 300)
  400..527     velocity tokens (token = velocity + 400, optional)
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from adt_str_tpu_torch.config import TokenizerConfig
from adt_str_tpu_torch.utils.mappings import ADTOF_LUT, ADTOF_MAPPING, GM_STANDARD_TO_GM_CUSTOM_LUT

TIME_OFFSET = 4
PITCH_OFFSET = 300
VELOCITY_OFFSET = 400


class MidiTokenizer:
    def __init__(self, config: TokenizerConfig):
        self.ADTOF_mapping = config.ADTOF_mapping
        self.BOS_token = config.BOS_token
        self.EOS_token = config.EOS_token
        self.pad_token = config.pad_token
        self.silence_token = config.silence_token
        self.add_velocity = config.add_velocity
        self.tokens_per_note = 3 if self.add_velocity else 2  # time, pitch[, velocity]

    def map_notes_to_Gm_custom(
        self, notes: np.ndarray, random_velocity: bool = False, rng: np.random.Generator | None = None
    ) -> np.ndarray:
        """GM-standard -> GM-custom (and under ADTOF -> ADTOF class) pitch
        remap of float32 note rows, with optional random velocities in
        [10, 126] from `rng`. An unknown pitch raises a KeyError, as the
        reference's dict lookup does."""
        notes = np.asarray(notes, dtype=np.float32).copy()
        if notes.size == 0:
            return notes
        pitches = notes[:, 2].astype(np.int64)
        if np.any((pitches < 0) | (pitches > 127)):
            raise KeyError(f"pitch out of MIDI range: {pitches}")
        mapped = GM_STANDARD_TO_GM_CUSTOM_LUT[pitches]
        if np.any(mapped < 0):
            raise KeyError(f"pitch not in GM drum mapping: {pitches[mapped < 0].tolist()}")
        if self.ADTOF_mapping:
            mapped = ADTOF_LUT[mapped]
        notes[:, 2] = mapped.astype(np.float32)
        if random_velocity:
            rng = rng or np.random.default_rng()
            notes[:, 3] = rng.integers(10, 127, size=notes.shape[0]).astype(np.float32)
        return notes

    def notes_to_adt_tokens(self, notes) -> np.ndarray:
        """[BOS, (time, pitch[, velocity])*, EOS] int64 tokens of (n, 4)
        [onset, offset, pitch, velocity] rows. The time token is
        `int(onset * 100) + 4` computed on float32 onsets (the product is
        rounded to float32, then truncated); a time token past the time
        range raises, as the reference's assertion does."""
        notes = np.asarray(notes, dtype=np.float32)
        if notes.size == 0:
            return np.array([self.BOS_token, self.EOS_token], dtype=np.int64)
        time_tok = np.trunc(notes[:, 0] * np.float32(100.0)).astype(np.int64) + TIME_OFFSET
        if np.any(time_tok >= PITCH_OFFSET):
            raise AssertionError("Time token is out of range")
        cols = [time_tok, notes[:, 2].astype(np.int64) + PITCH_OFFSET]
        if self.add_velocity:
            cols.append(notes[:, 3].astype(np.int64) + VELOCITY_OFFSET)
        body = np.stack(cols, axis=1).reshape(-1)
        return np.concatenate([[self.BOS_token], body, [self.EOS_token]]).astype(np.int64)

    def empty_adt_tokens(self) -> np.ndarray:
        """[BOS, silence, EOS]: the tokens of an injected empty segment."""
        return np.array([self.BOS_token, self.silence_token, self.EOS_token], dtype=np.int64)

    def encode_padded(self, notes, max_tokens: int) -> tuple[np.ndarray, int]:
        """(max_tokens,) int64 tokens padded with PAD, and their length.
        Notes that overflow `max_tokens` are dropped whole (never part of a
        time/pitch/velocity group), and EOS still ends the row."""
        tokens = self.notes_to_adt_tokens(notes)
        if len(tokens) > max_tokens:
            n_notes = (max_tokens - 2) // self.tokens_per_note
            tokens = np.concatenate([tokens[: 1 + n_notes * self.tokens_per_note], [self.EOS_token]]).astype(np.int64)
        out = np.full(max_tokens, self.pad_token, dtype=np.int64)
        out[: len(tokens)] = tokens
        return out, len(tokens)

    def decode(self, tokens) -> np.ndarray:
        """Token sequence -> [onset, onset+0.1, pitch, velocity] float64 rows.

        Keeps the reference decoder's quirks: a pitch token attaches only
        when the index just before held a time token, a velocity token when
        index-2 did; rows are zipped positionally; with no velocity decoded
        at all, velocity defaults to 100; under ADTOF the pitch goes through
        the ADTOF map. float64 onsets matter: the matcher sees exact grid
        values (0.04), and float32 ones flip matches at |dt| == 0.05."""
        onsets: dict[int, float] = {}
        pitches: dict[int, float] = {}
        velocities: dict[int, float] = {}
        for i, token in enumerate(np.asarray(tokens).tolist()):
            token = int(token)
            if token in (self.BOS_token, self.EOS_token):
                continue
            if TIME_OFFSET <= token < PITCH_OFFSET:
                onsets[i] = (token - TIME_OFFSET) / 100
            elif PITCH_OFFSET <= token < VELOCITY_OFFSET:
                pitch = token - PITCH_OFFSET
                if self.ADTOF_mapping:
                    pitch = ADTOF_MAPPING.get(pitch, pitch)
                if i - 1 not in onsets:
                    continue
                pitches[i - 1] = pitch
            elif token >= VELOCITY_OFFSET:
                if i - 2 not in onsets:
                    continue
                velocities[i - 2] = token - VELOCITY_OFFSET

        if len(velocities) == 0:
            velocities = defaultdict(float)
            for i in range(len(onsets)):
                velocities[i] = 100

        notes = [
            [onset, onset + 0.1, pitch, velocity]
            for onset, pitch, velocity in zip(
                onsets.values(), pitches.values(), velocities.values()
            )
        ]
        return np.array(notes, dtype=np.float64)

    def truncate_at_eos(self, tokens: np.ndarray) -> np.ndarray:
        """Stop at the first EOS or PAD (the eval convention)."""
        tokens = np.asarray(tokens)
        stop = np.where((tokens == self.EOS_token) | (tokens == self.pad_token))[0]
        return tokens[: stop[0]] if len(stop) else tokens
