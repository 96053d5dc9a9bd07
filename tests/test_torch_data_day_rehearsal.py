"""Data-day rehearsal through the port's CLIs: the six stages of
`tools/data_day_rehearsal.py` (midi_parser -> CLAP curation -> copy
originals -> HDF5 pack -> train -> eval), each `python -m
adt_str_tpu_torch...` as a subprocess on the CPU, on the same learnable
corpus (SR 4000, pitches 35, 38 and 42, the learnability protocol), ending
with the same onset-F1 > 0.75 assertion on a held-out render of the parsed
notes. Stage tests prove each CLI alone; this one pins the interfaces
between them (file layouts, config keys, checkpoints).
"""

import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from adt_str_tpu_torch.clap import model as tmodel
from adt_str_tpu_torch.config import SynthConfig
from adt_str_tpu_torch.synth import render
from adt_str_tpu_torch.synth.bank import load_bank_hdf5
from adt_str_tpu_torch.training.checkpoint import latest_checkpoint
from adt_str_tpu_torch.utils.audio_io import write_wav
from adt_str_tpu_torch.utils.midi_io import write_midi
from test_torch_clap import REAL_INPUT_AUDIO, archs

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("data_day_rehearsal", REPO / "tools" / "data_day_rehearsal.py")
rehearsal = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(rehearsal)  # the JAX run's corpus constants and one-shot timbres
SR, CLAP_SR, PITCHES, MAX_TOKENS = rehearsal.SR, rehearsal.CLAP_SR, rehearsal.PITCHES, rehearsal.MAX_TOKENS
STEPS, THRESHOLD = 400, 0.75


def yaml_text(sections: dict) -> str:
    """Sections of scalars and flat lists as YAML the port's reader takes."""
    lines = []
    for name, fields in sections.items():
        lines.append(f"{name}:")
        lines.extend(f"  {k}: {json.dumps(v)}" for k, v in fields.items())
    return "\n".join(lines) + "\n"


def synth_corpus(raw: Path, rng: np.random.Generator) -> dict:
    """The JAX rehearsal's corpus, written with the port's own writers: a
    Lakh-style MIDI tree, a reference-class tree, an unstructured sample
    pack and a small CLAP checkpoint in HF's layout (random weights: the
    training reads only the gold bin)."""
    midi_root = raw / "lakh"
    (midi_root / "A").mkdir(parents=True)
    for i in range(12):
        n = int(rng.integers(2, 5))
        onsets = np.sort(np.round(rng.uniform(0.0, 0.5, n), 2))
        notes = np.stack([onsets, onsets + 0.05, rng.choice(PITCHES, n), rng.integers(60, 127, n)], axis=1)
        write_midi(midi_root / "A" / f"song_{i:03d}.mid", notes, is_drum=True)
    ref_root = raw / "reference"
    for p in PITCHES:
        (ref_root / str(p)).mkdir(parents=True)
        for k in range(3):
            write_wav(ref_root / str(p) / f"ref_{p}_{k}.wav", rehearsal._one_shot(rng, p, k, SR), SR)
    pack_root = raw / "sample_pack"
    for j in range(18):
        sub = pack_root / f"vendor_{j % 3}" / f"kit_{j % 2}"
        sub.mkdir(parents=True, exist_ok=True)
        write_wav(sub / f"shot_{j:02d}.wav", rehearsal._one_shot(rng, PITCHES[j % len(PITCHES)], j % 5, SR), SR)
    (ta, tt), _ = archs(REAL_INPUT_AUDIO)
    clap_dir = tmodel.save_checkpoint(raw / "clap_tiny", tmodel.random_state_dict(ta, tt, seed=0), ta, tt)
    return {"midi_root": str(midi_root), "ref_root": str(ref_root), "pack_root": str(pack_root),
            "clap_dir": str(clap_dir)}


def run_stage(args: list, timeout: int = 1800) -> float:
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, f"{args}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}"
    return time.perf_counter() - t0


def eval_parquet(prefix: str, train_shard: Path, out: Path, n_clips: int = 8) -> None:
    """An ENST-style eval shard: the parsed notes rendered again through the
    port's renderer from the packed gold bin with held-out draws."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    notes_col = pq.read_table(train_shard, columns=["notes"])["notes"]
    all_notes = [np.frombuffer(b.as_py(), np.float32).reshape(-1, 4) for b in notes_col][:n_clips]
    bank = load_bank_hdf5(f"{prefix}@{SR}.hdf5", max_len=int(0.25 * SR), n_allowed_bins=1)
    statics = render.SynthStatics.from_bank(bank, device="cpu")
    cfg = SynthConfig(sample_rate=SR, input_sec=rehearsal.INPUT_SEC, mixup_range=0.2, use_fx_prob=0.0,
                      similarity_threshold=1.0, max_notes=8, max_oneshot_sec=0.25)
    B = len(all_notes)
    notes, mask = np.zeros((B, 8, 4), np.float32), np.zeros((B, 8), bool)
    for i, n in enumerate(all_notes):
        notes[i], mask[i] = render.pad_notes(n[:8], 8)
    draws = render.draw_render(statics, B, cfg, torch.Generator().manual_seed(424242))
    wavs = render.render_batch(statics, torch.from_numpy(notes), torch.from_numpy(mask), draws, cfg).numpy()
    rows = {"audio_id": [f"drummer_1_clip_{i}.wav" for i in range(B)], "drummer": ["drummer_1"] * B,
            "audio": [w.astype(np.float32).tobytes() for w in wavs], "sample_rate": [SR] * B,
            "notes": [notes[i][mask[i]].tobytes() for i in range(B)]}
    schema = pa.schema([pa.field("audio_id", pa.string()), pa.field("drummer", pa.string()),
                        pa.field("audio", pa.binary()), pa.field("sample_rate", pa.int32()),
                        pa.field("notes", pa.binary())])
    pq.write_table(pa.table(rows, schema=schema), out)


@pytest.mark.slow
def test_port_data_day_rehearsal_chain(tmp_path):
    work, times = tmp_path, {}
    corpus = synth_corpus(work / "raw", np.random.default_rng(0))
    shared = rehearsal.SHARED

    dump = work / "parsed"
    (work / "make_dataset.yaml").write_text(yaml_text({"shared": shared, "preprocess": {
        "midi_root": corpus["midi_root"], "dump_path": str(dump), "partitions": ["A"], "n_jobs": 1,
        "dataset_name": "lakh_matched"}}))
    times["1_midi_parser"] = run_stage(["adt_str_tpu_torch.scripts.midi_parser", str(work / "make_dataset.yaml")])
    shards = sorted((dump / "lakh_matched").glob("*.parquet"))
    assert shards

    (work / "clap.yaml").write_text(yaml_text({"shared": {"sample_rate": CLAP_SR}, "clap_config": {
        "model_name": corpus["clap_dir"], "batch_size": 8, "sample_pack_root": corpus["pack_root"],
        "reference_root": corpus["ref_root"]}}))
    times["2_clap_curation"] = run_stage(["adt_str_tpu_torch.scripts.augment_data_with_clap", str(work / "clap.yaml"),
                                          "--num_bins", "10", "--device", "cpu"])
    augmented = Path(corpus["ref_root"] + "_clap_augmented")
    assert augmented.is_dir()

    times["3_copy_originals"] = run_stage(["adt_str_tpu_torch.scripts.copy_originals_to_augmented",
                                           corpus["ref_root"]])
    assert len(list(augmented.glob("*/gold/*.wav"))) == 3 * len(PITCHES)

    prefix = str(work / "oneshots")
    times["4_hdf5_pack"] = run_stage(["adt_str_tpu_torch.scripts.convert_augmented_to_hdf5", str(augmented), prefix,
                                      "--sample_rate", str(SR), "--overwrite"])
    assert Path(f"{prefix}@{SR}.hdf5").exists()

    run_dir = work / "run"
    (work / "train.yaml").write_text(yaml_text({
        "shared": shared, "model": rehearsal.MODEL_SECTION, "tokenizer": rehearsal.TOKENIZER,
        "synthetiser": {"oneshot_path": prefix, "similarity_threshold": 1.0, "mixup_range": 0.2, "use_fx_prob": 0.0,
                        "max_notes": 8, "max_oneshot_sec": 0.25},
        "TrainDatasetConfig": {"dataset_path": str(dump / "lakh_matched"), "dataset_name": "Lakh",
                               "max_tokens": MAX_TOKENS, "empty_tokens_percentage": 0.0,
                               "random_velocity_prob": 0.0, "shuffle_buffer": 64, "seed": 0},
        "training": {"batch_size": 8, "learning_rate": 1e-3, "warmup_ratio": 0.05, "num_epochs": 10_000,
                     "max_steps": STEPS, "mixed_precision": "no", "gradient_accumulation_steps": 1},
        "logging": {"output_dir": str(run_dir), "logging_steps": 100},
        "checkpoint": {"max_checkpoints": 1},
        "experiment": {"seed": 0, "run_name": "data_day_rehearsal"}}))
    times["5_train"] = run_stage(["adt_str_tpu_torch.train", str(work / "train.yaml"), "--device", "cpu"],
                                 timeout=3600)
    ckpt = latest_checkpoint(run_dir / "data_day_rehearsal")
    assert ckpt and (Path(ckpt) / "model.safetensors").exists()

    t0 = time.perf_counter()
    eval_parquet(prefix, shards[0], work / "enst_eval.parquet")
    out_dir = work / "results"
    (work / "eval.yaml").write_text(yaml_text({
        "shared": shared, "model": rehearsal.MODEL_SECTION, "tokenizer": rehearsal.TOKENIZER,
        "EvalDatasetConfig": {"dataset_path": str(work / "enst_eval.parquet"), "dataset_name": "ENST",
                              "minus_one": False},
        "inference": {"checkpoint_path": str(ckpt), "batch_size": 8, "max_length": MAX_TOKENS,
                      "use_beam_search": False, "output_path": str(out_dir)}}))
    run_stage(["adt_str_tpu_torch.eval", str(work / "eval.yaml"), "-e", "--device", "cpu"])
    times["6_eval"] = time.perf_counter() - t0
    metrics = json.loads((out_dir / "metrics.json").read_text())["all"]
    print(json.dumps({"stage_wall_seconds": times, "total_wall_seconds": sum(times.values()), "metrics": metrics}))
    assert metrics["f_measure"] > THRESHOLD, metrics
