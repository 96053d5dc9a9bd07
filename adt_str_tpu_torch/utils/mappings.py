"""Drum pitch mapping tables the port's tokenizer, synthesiser and
evaluation need.

Port of `adt_str_tpu/utils/mappings.py` (its own copy of the data; the other
tables join when a slice needs them). The tables are data and must match
the reference byte for byte for token and metric parity. The `*_LUT`
tables are dense 128-entry versions of the dicts (-1 where a pitch is
unmapped).
"""

from __future__ import annotations

import numpy as np

# GM standard percussion pitches (35-81) -> reduced "GM custom" set (35-60).
GM_STANDARD_TO_GM_CUSTOM = {
    35: 35,  # Acoustic Bass Drum
    36: 36,  # Bass Drum 1
    37: 37,  # Side Stick
    38: 38,  # Acoustic Snare
    39: 39,  # Hand Clap
    40: 40,  # Electric Snare
    41: 41,  # Floor Tom
    42: 42,  # Closed Hi Hat
    43: 41,  # High floor tom -> Floor Tom
    44: 43,  # Pedal Hi-Hat
    45: 41,  # Low Tom -> Floor Tom
    46: 44,  # Open Hi-Hat
    47: 45,  # Low Mid Tom -> Mid Tom
    48: 45,  # High Mid Tom -> Mid Tom
    49: 46,  # Crash Cymbal
    50: 47,  # High Tom
    51: 48,  # Ride Cymbal
    52: 49,  # Chinese Cymbal
    53: 48,  # Ride Bell -> Ride Cymbal
    54: 50,  # Tambourine
    55: 51,  # Splash Cymbal
    56: 52,  # Cowbell
    57: 46,  # Crash Cymbal 2 -> Crash Cymbal
    58: 53,  # Vibraslap
    59: 48,  # Ride Cymbal 2 -> Ride Cymbal
    60: 54,  # Hi Bongo -> Congas & Timbales
    61: 54,  # Low Bongo -> Congas & Timbales
    62: 54,  # Mute Hi Conga -> Congas & Timbales
    63: 54,  # Open Hi Conga -> Congas & Timbales
    64: 54,  # Low Conga -> Congas & Timbales
    65: 54,  # High Timbale -> Congas & Timbales
    66: 54,  # Low Timbale -> Congas & Timbales
    67: 52,  # High Agogo -> Cowbell
    68: 52,  # Low Agogo -> Cowbell
    69: 55,  # Cabasa -> Shaker
    70: 55,  # Maracas -> Shaker
    71: 56,  # Short Whistle -> Whistle
    72: 56,  # Long Whistle -> Whistle
    73: 57,  # Short Guiro -> Guiro
    74: 57,  # Long Guiro -> Guiro
    75: 58,  # Claves
    76: 58,  # Hi Wood Block -> Claves
    77: 58,  # Low Wood Block -> Claves
    78: 59,  # Mute Cuica -> Cuica
    79: 59,  # Open Cuica -> Cuica
    80: 60,  # Mute Triangle -> Triangle
    81: 60,  # Open Triangle -> Triangle
}

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

GM_REDUCED_NAME_CONVENTION = {
    35: "Acoustic Bass Drum",
    36: "Bass Drum 1",
    37: "Side Stick",
    38: "Acoustic Snare",
    39: "Hand Clap",
    40: "Electric Snare",
    41: "Floor Tom",
    42: "Closed Hi Hat",
    43: "Pedal Hi-Hat",
    44: "Open Hi-Hat",
    45: "Mid Tom",
    46: "Crash Cymbal",
    47: "High Tom",
    48: "Ride Cymbal",
    49: "Chinese Cymbal",
    50: "Tambourine",
    51: "Splash Cymbal",
    52: "Cowbell",
    53: "Vibraslap",
    54: "Congas & Timbales",
    55: "Shaker",
    56: "Whistle",
    57: "Guiro",
    58: "Claves",
    59: "Cuica",
    60: "Triangle",
}


def _make_lut(mapping: dict[int, int]) -> np.ndarray:
    """Dense 128-entry int32 lookup table; unmapped pitches -> -1."""
    lut = np.full(128, -1, dtype=np.int32)
    for k, v in mapping.items():
        lut[k] = v
    return lut


GM_STANDARD_TO_GM_CUSTOM_LUT = _make_lut(GM_STANDARD_TO_GM_CUSTOM)
ADTOF_LUT = _make_lut(ADTOF_MAPPING)
