"""Single-file transcription CLI on one GPU:
`python -m adt_str_tpu_torch.inference <audio> <config.yaml> [-o DIR] [-s] [--hop_sec S] [--device D]`.

Port of the root `inference.py`: load the audio, resample it to the
configured rate and mix it to mono, split it into `input_sec` chunks (the
tail zero-padded; `--hop_sec` gives overlapping chunks), greedy-decode all
chunks in one batch, shift each chunk's notes by its start, merge and
dedup them, and write `<stem>.mid`. `-s` resynthesises the transcription
through the on-device drum synthesiser from the one-shot bank
`f"{oneshot_path}@{sample_rate}.hdf5"` (reading it needs h5py) and writes
`<stem>_resynth.wav`. Runs on cuda unless `--device` names another device.

`transcribe` and `resynthesize` are the model-facing parts, callable
with a model and a bank already on the device.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np
import torch

from adt_str_tpu_torch import resolve_device
from adt_str_tpu_torch.config import FrameworkConfig, SynthConfig
from adt_str_tpu_torch.domain.segmenter import Segmenter, chunk_wave
from adt_str_tpu_torch.domain.tokenizer import MidiTokenizer
from adt_str_tpu_torch.evaluation.notes import decode_tokens_to_notes, merge_chunk_notes
from adt_str_tpu_torch.models.adt import ADTModel
from adt_str_tpu_torch.models.convert import load_reference_checkpoint
from adt_str_tpu_torch.models.decode import greedy_decode
from adt_str_tpu_torch.synth.bank import load_bank_hdf5, n_allowed_bins
from adt_str_tpu_torch.synth.render import SynthStatics, draw_render, pad_notes, render_batch
from adt_str_tpu_torch.utils.audio_io import load_and_resample, write_wav
from adt_str_tpu_torch.utils.midi_io import write_midi


def chunk_audio(wave: np.ndarray, chunk_samples: int, hop_samples: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """1-D wave -> (chunks (N, chunk_samples) zero-padded, start samples (N,))."""
    triples = chunk_wave(wave, chunk_samples, hop_samples)
    return np.stack([c for _, c, _ in triples]), np.array([s for s, _, _ in triples])


def transcribe(model: ADTModel, cfg: FrameworkConfig, wave: np.ndarray, tokenizer: MidiTokenizer, device=None,
               hop_sec: float | None = None) -> np.ndarray:
    """Chunked greedy transcription of a 1-D wave at the config's rate ->
    float64 [onset, offset, pitch, velocity] rows. With `hop_sec` the chunks
    overlap and the merge snaps shifted times to the 10 ms grid, so a note
    seen by two chunks is kept once (use a multiple of 0.01 s)."""
    device = resolve_device(device)
    hop = int(hop_sec * cfg.shared.sample_rate) if hop_sec else None
    chunks, starts = chunk_audio(wave, cfg.shared.chunk_samples, hop)
    tokens = greedy_decode(
        model.to(device).eval(), torch.from_numpy(chunks).to(device), max_length=int(cfg.inference.max_length),
        start_token=tokenizer.BOS_token, end_token=tokenizer.EOS_token,
    ).cpu().numpy()
    all_notes = []
    for i, start in enumerate(starts):
        notes = decode_tokens_to_notes(tokenizer, tokens[i])
        if len(notes):
            notes[:, 0:2] += start / cfg.shared.sample_rate
            all_notes.append(notes)
    return merge_chunk_notes(all_notes, snap_to_grid=hop_sec is not None)


def resynthesize(notes: np.ndarray, synth: SynthConfig, statics: SynthStatics, seed: int = 0) -> np.ndarray:
    """Notes -> the synthesiser's f32 audio, `input_sec` chunk after chunk
    (a note that crosses a chunk boundary is dropped), rendered on the
    statics' device with draws from a torch.Generator seeded `seed`."""
    chunks = Segmenter(synth).chunk_notes(notes)
    padded, masks = zip(*(pad_notes(c, synth.max_notes) for c in chunks))
    dev = statics.waveforms.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    draws = draw_render(statics, len(chunks), synth, gen)
    wavs = render_batch(statics, torch.from_numpy(np.stack(padded)), torch.from_numpy(np.stack(masks)), draws, synth)
    return wavs.cpu().numpy().reshape(-1)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="ADT inference on one GPU")
    parser.add_argument("input_path", type=str)
    parser.add_argument("config_path", type=str)
    parser.add_argument("-o", "--output_path", type=str, default="outputs/")
    parser.add_argument("-s", "--synthetise_transcription", action="store_true")
    parser.add_argument("--hop_sec", type=float, default=None,
                        help="overlap hop in seconds (< input_sec): boundary notes are seen "
                        "by an uncut chunk; use a multiple of 0.01 so duplicates dedup")
    parser.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    os.makedirs(args.output_path, exist_ok=True)
    input_stem = Path(args.input_path).stem
    cfg = FrameworkConfig.from_yaml(args.config_path)
    # check what the run needs before the transcription
    if not cfg.inference.checkpoint_path:
        raise SystemExit("config needs an `inference:` section with `checkpoint_path` set")
    if args.synthetise_transcription and cfg.synthetiser is None:
        raise SystemExit("-s/--synthetise_transcription needs a `synthetiser:` section (oneshot_path etc.) in the config")
    device = resolve_device(args.device)
    model = ADTModel(cfg.model, device=device)
    model.load_state_dict(load_reference_checkpoint(cfg.inference.checkpoint_path, device), strict=True)
    tokenizer = MidiTokenizer(cfg.tokenizer)

    print(f"Loading audio: {args.input_path}")
    wave = load_and_resample(args.input_path, cfg.shared.sample_rate)
    notes = transcribe(model, cfg, wave, tokenizer, device=device, hop_sec=args.hop_sec)
    midi_path = os.path.join(args.output_path, f"{input_stem}.mid")
    write_midi(midi_path, notes, is_drum=True)
    print(f"Transcription saved to: {midi_path} ({len(notes)} notes)")

    if args.synthetise_transcription and len(notes):
        print("Synthesizing transcription...")
        synth = cfg.synthetiser
        # only the similarity bins the threshold allows are read
        bank = load_bank_hdf5(f"{synth.oneshot_path}@{synth.sample_rate}.hdf5",
                              int(synth.max_oneshot_sec * synth.sample_rate),
                              n_allowed_bins=n_allowed_bins(synth.similarity_threshold))
        resynth = resynthesize(notes, synth, SynthStatics.from_bank(bank, device=device))
        out = os.path.join(args.output_path, f"{input_stem}_resynth.wav")
        write_wav(out, resynth, synth.sample_rate)
        print(f"Resynthesized audio saved to: {out}")


if __name__ == "__main__":
    main()
