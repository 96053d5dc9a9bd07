"""Drum pitch mapping tables the port's tokenizer and synthesiser need.

Port of `adt_str_tpu/utils/mappings.py` (its own copy of the data; the other
tables join when a slice needs them). The tables are data and must match
the reference byte for byte for token and metric parity. `ADTOF_LUT` is the
dense 128-entry table of `ADTOF_MAPPING` (-1 where a pitch is unmapped).
"""

from __future__ import annotations

import numpy as np

# GM custom (35-61) -> ADTOF 8-class reduction.
ADTOF_MAPPING = {
    35: 35,  # Acoustic Bass Drum
    36: 35,  # Bass Drum 1 -> BD
    37: 38,  # Side Stick -> SD
    38: 38,  # Acoustic Snare
    39: 38,  # Hand Clap -> SD
    40: 38,  # Electric Snare -> SD
    41: 41,  # Floor Tom
    42: 42,  # Closed Hi Hat
    43: 42,  # Pedal Hi-Hat -> HH
    44: 42,  # Open Hi-Hat -> HH
    45: 41,  # Mid Tom -> TT
    46: 48,  # Crash Cymbal -> CY+RD
    47: 41,  # High Tom -> TT
    48: 48,  # Ride Cymbal
    49: 48,  # Chinese Cymbal -> CY+RD
    50: 42,  # Tambourine -> HH
    51: 48,  # Splash Cymbal -> CY+RD
    52: 52,  # Cowbell
    53: 61,  # Vibraslap -> Other
    54: 61,  # Congas & Timbales -> Other
    55: 61,  # Shaker -> Other
    56: 61,  # Whistle -> Other
    57: 61,  # Guiro -> Other
    58: 58,  # Claves
    59: 61,  # Cuica -> Other
    60: 61,  # Triangle -> Other
    61: 61,  # Other
}

ADTOF_INVERSE_MAPPING = {
    35: [35, 36],
    38: [37, 38, 39, 40],
    41: [41, 45, 47],
    42: [42, 43, 44, 50],
    48: [46, 48, 49, 51],
    52: [52],
    58: [58],
    61: [53, 54, 55, 56, 57, 59, 60],
}

ADTOF_LABEL_MAPPING = {
    35: "BD",
    38: "SD",
    41: "TT",
    42: "HH",
    48: "CY + RD",
    52: "Cowbell",
    58: "Claves",
    61: "Other",
}


def _make_lut(mapping: dict[int, int]) -> np.ndarray:
    """Dense 128-entry int32 lookup table; unmapped pitches -> -1."""
    lut = np.full(128, -1, dtype=np.int32)
    for k, v in mapping.items():
        lut[k] = v
    return lut


ADTOF_LUT = _make_lut(ADTOF_MAPPING)
