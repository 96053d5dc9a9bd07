"""MIDI token decoding: token sequence -> note rows.

Port of `adt_str_tpu/domain/tokenizer.py:MidiTokenizer` (decode side only,
through its pure-Python decode `_decode_python`; the native extension and
the encoders join with the training slice).

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
from adt_str_tpu_torch.utils.mappings import ADTOF_MAPPING

TIME_OFFSET = 4
PITCH_OFFSET = 300
VELOCITY_OFFSET = 400


class MidiTokenizer:
    def __init__(self, config: TokenizerConfig):
        self.ADTOF_mapping = config.ADTOF_mapping
        self.BOS_token = config.BOS_token
        self.EOS_token = config.EOS_token
        self.pad_token = config.pad_token

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
