"""CLAP: the audio and text towers and the one-shot library curation.

Port of `adt_str_tpu/clap/`. The short-clip feature path runs K1
(`ops/cuda_mel.py`) at CLAP's 48 kHz dB frontend.
"""
