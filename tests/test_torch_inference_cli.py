"""The port's offline transcription (`python -m adt_str_tpu_torch.inference`)
on the CPU against the root `inference.py`: `transcribe`'s notes equal
JAX's (plain and overlapping chunks), the CLI's MIDI file is byte-equal to
`inference.py`'s on the same checkpoint and wave, `Segmenter.chunk_notes`
equals JAX's, `write_wav` round-trips, `-s` writes a resynthesis of the
expected length from an HDF5 bank, and the three new CLIs refuse to run
without CUDA unless given `--device`."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from adt_str_tpu.config import FrameworkConfig as JFrameworkConfig
from adt_str_tpu.config import SharedConfig as JSharedConfig
from adt_str_tpu.domain.segmenter import Segmenter as JSegmenter
from adt_str_tpu.domain.tokenizer import MidiTokenizer as JMidiTokenizer
from adt_str_tpu.synth.bank import save_bank_hdf5
from adt_str_tpu_torch import inference as tinference
from adt_str_tpu_torch.config import FrameworkConfig, SharedConfig
from adt_str_tpu_torch.domain.segmenter import Segmenter
from adt_str_tpu_torch.domain.tokenizer import MidiTokenizer
from adt_str_tpu_torch.utils.audio_io import read_wav, write_wav
from test_torch_eval import SR, checkpoint_dir, crafted, port_model, run_cli, tiny_config  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _jax_inference():
    sys.path.insert(0, str(REPO))
    try:
        import inference
    finally:
        sys.path.remove(str(REPO))
    return inference


def _wave(seconds: float, seed: int = 0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=int(seconds * SR)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("hop_sec", [None, 0.32])
def test_transcribe_notes_equal_jax(crafted, hop_sec):
    raw = tiny_config(inference={"max_length": 16})
    cfg, jcfg = FrameworkConfig.from_dict(raw), JFrameworkConfig.from_dict(raw)
    wave = _wave(1.9)
    got = tinference.transcribe(port_model(crafted, cfg), cfg, wave, MidiTokenizer(cfg.tokenizer), device="cpu",
                                hop_sec=hop_sec)
    ref = _jax_inference().transcribe(crafted, jcfg, wave, JMidiTokenizer(jcfg.tokenizer), hop_sec=hop_sec)
    assert got.dtype == ref.dtype == np.float64
    assert len(got) == 4 * (3 if hop_sec is None else 6)  # four notes a chunk
    np.testing.assert_array_equal(got, ref)


def _cli_config(tmp_path, checkpoint_dir, name, **sections) -> Path:
    raw = tiny_config(inference={"checkpoint_path": checkpoint_dir, "max_length": 16}, **sections)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return path


@pytest.mark.parametrize("hop, n_notes", [([], 12), (["--hop_sec", "0.32"], 20)], ids=["plain", "hop"])
def test_cli_midi_bytes_equal_inference_py(tmp_path, checkpoint_dir, hop, n_notes):
    """1.5 s: 3 chunks, or 5 at a 0.32 s hop, of four notes each."""
    wav = tmp_path / "song.wav"
    write_wav(wav, _wave(1.5, seed=1), SR)
    cfg = _cli_config(tmp_path, checkpoint_dir, "cfg")
    port = run_cli(["-m", "adt_str_tpu_torch.inference", str(wav), str(cfg), "-o", str(tmp_path / "port"),
                    "--device", "cpu", *hop])
    run_cli(["inference.py", str(wav), str(cfg), "-o", str(tmp_path / "jax"), *hop])
    midi = (tmp_path / "port" / "song.mid").read_bytes()
    assert midi[:4] == b"MThd" and f"({n_notes} notes)" in port.stdout
    assert midi == (tmp_path / "jax" / "song.mid").read_bytes()


def test_cli_resynthesis_writes_the_expected_length(tmp_path, checkpoint_dir):
    rng = np.random.default_rng(3)
    entries = {p: {"gold": [(np.exp(-np.arange(400) / 150) * rng.normal(size=400)).astype(np.float32)]}
               for p in range(35, 62)}
    prefix = tmp_path / "oneshot"
    save_bank_hdf5(f"{prefix}@{SR}.hdf5", entries, SR)
    wav = tmp_path / "song.wav"
    write_wav(wav, _wave(1.0, seed=2), SR)
    synth = {"oneshot_path": str(prefix), "similarity_threshold": 1.0, "mixup_range": 0.2, "use_fx_prob": 0.0,
             "max_notes": 16, "max_oneshot_sec": 0.1}
    cfg = _cli_config(tmp_path, checkpoint_dir, "cfg", synthetiser=synth)
    proc = run_cli(["-m", "adt_str_tpu_torch.inference", str(wav), str(cfg), "-o", str(tmp_path / "out"), "-s",
                    "--device", "cpu"])
    assert "Resynthesized audio saved" in proc.stdout
    out, sr = read_wav(tmp_path / "out" / "song_resynth.wav")
    # the last note ends at 0.64 + 0.65 s, in the third 0.64 s chunk
    assert sr == SR and out.shape == (3 * int(0.64 * SR),) and out.dtype == np.float32
    assert np.isfinite(out).all() and np.abs(out).max() > 0


def test_chunk_notes_equal_jax():
    rng = np.random.default_rng(6)
    on = rng.uniform(0, 3.0, 40)
    notes = np.stack([on, on + rng.uniform(0.01, 0.5, 40), rng.integers(35, 62, 40), rng.integers(1, 128, 40)], 1)
    for sec in (0.64, 2.56):
        got = Segmenter(SharedConfig(input_sec=sec)).chunk_notes(notes)
        ref = JSegmenter(JSharedConfig(input_sec=sec)).chunk_notes(notes)
        assert len(got) == len(ref) > 1
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(800,), (2, 800)])
def test_write_wav_round_trips(tmp_path, shape):
    wave = (np.random.default_rng(7).uniform(-1, 1, shape)).astype(np.float32)
    write_wav(tmp_path / "w.wav", wave, 22050)
    back, sr = read_wav(tmp_path / "w.wav")
    assert sr == 22050
    np.testing.assert_array_equal(back, wave)


@pytest.mark.parametrize("module, args", [("inference", ["song.wav", "cfg.yaml"]), ("eval", ["cfg.yaml"]),
                                          ("bench", [])])
def test_cli_needs_a_device_without_cuda(tmp_path, module, args):
    """On a machine without CUDA the CLIs raise unless `--device` is given;
    they never fall back to the CPU on their own."""
    (tmp_path / "song.wav").write_bytes(b"")
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(
        tiny_config(inference={"checkpoint_path": str(tmp_path)},
                    EvalDatasetConfig={"dataset_path": str(tmp_path / "none.parquet"), "dataset_name": "ENST"})))
    proc = subprocess.run([sys.executable, "-m", f"adt_str_tpu_torch.{module}", *args], cwd=tmp_path,
                          env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
