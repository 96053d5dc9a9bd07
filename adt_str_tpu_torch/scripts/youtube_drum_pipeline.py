"""End-to-end demo: YouTube (or local audio) -> Demucs drum stem -> ADT
transcription on the GPU -> MIDI + one-shot preview.

`python -m adt_str_tpu_torch.scripts.youtube_drum_pipeline (--url URL | --input-audio FILE) --config CFG.yaml
[--output-dir DIR] [--hop-sec S] [--skip-demucs] [--seed N] [--device D]`

Port of root `scripts/youtube_drum_pipeline.py` (the same flags, plus
`--device`): yt-dlp download (a subprocess; without yt-dlp it raises),
Demucs separation (`data/demucs_separate.py`; without demucs it raises),
chunking with an optional overlap hop (`domain/segmenter.py:chunk_wave`;
tail chunks with under `min_audio_samples` real samples are skipped), every
chunk decoded in one batched `greedy_decode` (or `beam_search_decode` when
the config's `inference.use_beam_search`) on the card, which runs K1 and,
with a flash config, K5f; notes through `evaluation/notes.py`, the ADTOF ->
GM remap with the 35-60 validity filter, `predicted_drums.mid` and
`synthesized_drums.wav` (`utils/drum_render.py`). The checkpoint is the
config's `inference.checkpoint_path`, read by
`models/convert.py:load_reference_checkpoint`.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from adt_str_tpu_torch import resolve_device
from adt_str_tpu_torch.config import FrameworkConfig
from adt_str_tpu_torch.domain.segmenter import chunk_wave
from adt_str_tpu_torch.domain.tokenizer import MidiTokenizer
from adt_str_tpu_torch.evaluation.notes import decode_tokens_to_notes, merge_chunk_notes
from adt_str_tpu_torch.models.adt import ADTModel
from adt_str_tpu_torch.models.convert import load_reference_checkpoint
from adt_str_tpu_torch.models.decode import beam_search_decode, greedy_decode
from adt_str_tpu_torch.utils.audio_io import load_and_resample, normalize, write_wav
from adt_str_tpu_torch.utils.mappings import ADTOF_INVERSE_MAPPING


def download_youtube(url: str, out_dir: Path) -> Path:
    """yt-dlp -> the newest WAV in `out_dir`; without yt-dlp it raises."""
    if shutil.which("yt-dlp") is None:
        raise RuntimeError("yt-dlp not found: install it or pass --input-audio")
    out_dir.mkdir(parents=True, exist_ok=True)
    subprocess.run(["yt-dlp", "-x", "--audio-format", "wav", "-o", str(out_dir / "%(id)s.%(ext)s"), url], check=True)
    wavs = sorted(out_dir.glob("*.wav"), key=lambda p: p.stat().st_mtime)
    if not wavs:
        raise FileNotFoundError(f"No WAV produced in {out_dir}")
    return wavs[-1]


def chunk_audio(wav: np.ndarray, chunk_samples: int, hop_samples: int | None = None):
    """(start, chunk, true_len) triples, `true_len` the unpadded sample count."""
    return chunk_wave(wav, chunk_samples, hop_samples)


def chunk_batch(cfg: FrameworkConfig, wav: np.ndarray, hop_sec: float | None = None,
                min_audio_samples: int = 1024) -> tuple[np.ndarray, np.ndarray]:
    """-> (start samples (N,), chunks (N, chunk_samples) f32) of the chunks
    with at least `min_audio_samples` real samples."""
    hop_samples = int(hop_sec * cfg.shared.sample_rate) if hop_sec else None
    pairs = [(s, c) for s, c, true_len in chunk_audio(wav, cfg.shared.chunk_samples, hop_samples)
             if true_len >= min_audio_samples]
    if not pairs:
        return np.zeros(0, np.int64), np.zeros((0, cfg.shared.chunk_samples), np.float32)
    return np.array([s for s, _ in pairs]), np.stack([c for _, c in pairs]).astype(np.float32)


def decode_chunks(model: ADTModel, cfg: FrameworkConfig, tokenizer: MidiTokenizer, chunks: np.ndarray,
                  device=None) -> np.ndarray:
    """(N, chunk_samples) chunks -> (N, max_length) tokens, every chunk in
    one batched decode on `device` (None: cuda)."""
    device = resolve_device(device)
    wave = torch.from_numpy(chunks).to(device)
    kw = dict(max_length=int(cfg.inference.max_length), start_token=tokenizer.BOS_token,
              end_token=tokenizer.EOS_token)
    if cfg.inference.use_beam_search:
        tokens = beam_search_decode(model, wave, beam_size=cfg.inference.beam_size, **kw)
    else:
        tokens = greedy_decode(model, wave, **kw)
    return tokens.cpu().numpy()


def run_model_on_chunks(model: ADTModel, cfg: FrameworkConfig, tokenizer: MidiTokenizer, wav: np.ndarray,
                        hop_sec: float | None = None, min_audio_samples: int = 1024, device=None) -> np.ndarray:
    """A 1-D wave at the config's rate -> merged float64 [onset, offset,
    pitch, velocity] rows; under `hop_sec` the shifted times snap to the
    10 ms grid before the dedup."""
    starts, chunks = chunk_batch(cfg, wav, hop_sec, min_audio_samples)
    if not len(starts):
        return np.zeros((0, 4), dtype=np.float32)
    tokens = decode_chunks(model, cfg, tokenizer, chunks, device)
    all_notes = []
    for i, start in enumerate(starts):
        notes = decode_tokens_to_notes(tokenizer, tokens[i])
        if len(notes):
            notes[:, 0:2] += start / cfg.shared.sample_rate
            all_notes.append(notes)
    return merge_chunk_notes(all_notes, snap_to_grid=hop_sec is not None)


def remap_notes_for_synth(notes: np.ndarray, adtof: bool, rng: np.random.Generator) -> np.ndarray:
    """ADTOF class -> a random member GM-custom pitch (`rng`); then only
    pitches 35-60 are kept."""
    if len(notes) == 0:
        return notes
    notes = notes.copy()
    if adtof:
        notes[:, 2] = [int(rng.choice(ADTOF_INVERSE_MAPPING.get(p, [p]))) for p in notes[:, 2].astype(int)]
    keep = (notes[:, 2] >= 35) & (notes[:, 2] <= 60)
    return notes[keep]


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="YouTube or local audio -> drum MIDI and a one-shot preview")
    parser.add_argument("--url", type=str, default=None)
    parser.add_argument("--input-audio", type=str, default=None)
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--output-dir", type=str, default="youtube_pipeline_output")
    parser.add_argument("--hop-sec", type=float, default=None)
    parser.add_argument("--skip-demucs", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    if not args.url and not args.input_audio:
        parser.error("one of --url / --input-audio is required")

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    cfg = FrameworkConfig.from_yaml(args.config)
    device = resolve_device(args.device)
    model = ADTModel(cfg.model, device=device)
    model.load_state_dict(load_reference_checkpoint(cfg.inference.checkpoint_path, device), strict=True)
    model.eval()
    tokenizer = MidiTokenizer(cfg.tokenizer)

    audio_path = Path(args.input_audio) if args.input_audio else download_youtube(args.url, out_dir)
    if not args.skip_demucs:
        from adt_str_tpu_torch.data.demucs_separate import separate_drums

        [audio_path] = separate_drums([str(audio_path)], str(out_dir / "demucs"))

    wav = normalize(load_and_resample(audio_path, cfg.shared.sample_rate))
    notes = run_model_on_chunks(model, cfg, tokenizer, wav, hop_sec=args.hop_sec, device=device)
    print(f"Transcribed {len(notes)} notes")

    from adt_str_tpu_torch.utils.drum_render import render_drum_preview

    synth_notes = remap_notes_for_synth(notes, cfg.tokenizer.ADTOF_mapping, rng)
    preview, _ = render_drum_preview(synth_notes, num_samples=len(wav), sample_rate=cfg.shared.sample_rate,
                                     midi_path=out_dir / "predicted_drums.mid")
    write_wav(out_dir / "synthesized_drums.wav", preview, cfg.shared.sample_rate)
    print(f"Wrote {out_dir / 'predicted_drums.mid'} and {out_dir / 'synthesized_drums.wav'}")


if __name__ == "__main__":
    main()
