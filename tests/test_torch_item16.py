"""The port's last modules against the JAX package's, on the CPU: multi-hot
token embeddings (`plain=False`), `DrumConfusionMatrix.get_matrix`, the
misc helpers, `render_segment`, `MappingUtils`, the HDF5 inspector, the
drum preview renderer, the Demucs wrapper and the YouTube demo
(`python -m adt_str_tpu_torch.scripts.youtube_drum_pipeline`).

Tolerances: multi-hot logits at fp32 to 1e-5 absolute (other summation
orders of the embedding product); everything else is host code held
equal (tokens, notes, counts, samples, file bytes)."""

import importlib.util
import os
import random
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from adt_str_tpu.config import FrameworkConfig as JFrameworkConfig
from adt_str_tpu.data import demucs_separate as jdemucs
from adt_str_tpu.domain.tokenizer import MidiTokenizer as JMidiTokenizer
from adt_str_tpu.evaluation import confusion as jconf
from adt_str_tpu.models import adt as jadt
from adt_str_tpu.models import decode as jdecode
from adt_str_tpu.synth import render as jrender
from adt_str_tpu.utils import drum_render as jdrum
from adt_str_tpu.utils import inspect_hdf5 as jinspect
from adt_str_tpu.utils import mappings as jmappings
from adt_str_tpu.utils import misc as jmisc
from adt_str_tpu.utils.audio_io import load_and_resample as jload
from adt_str_tpu.utils.audio_io import normalize as jnormalize
from adt_str_tpu_torch.config import FrameworkConfig
from adt_str_tpu_torch.data import demucs_separate as tdemucs
from adt_str_tpu_torch.domain.tokenizer import MidiTokenizer
from adt_str_tpu_torch.evaluation import confusion as tconf
from adt_str_tpu_torch.models.convert import state_dict_from_jax_params, write_safetensors
from adt_str_tpu_torch.models.decode import greedy_decode
from adt_str_tpu_torch.scripts import youtube_drum_pipeline as tyt
from adt_str_tpu_torch.synth import render as trender
from adt_str_tpu_torch.synth.bank import make_test_bank
from adt_str_tpu_torch.utils import drum_render as tdrum
from adt_str_tpu_torch.utils import inspect_hdf5 as tinspect
from adt_str_tpu_torch.utils import mappings as tmappings
from adt_str_tpu_torch.utils import misc as tmisc
from adt_str_tpu_torch.utils.audio_io import write_wav
from test_torch_eval import SR, crafted, port_model, run_cli, tiny_config  # noqa: F401 (fixture)
from test_torch_synth import PITCHES, jax_render_draws
from test_torch_train_step import BASE, build

REPO = Path(__file__).resolve().parent.parent


def _jax_pipeline():
    spec = importlib.util.spec_from_file_location("jax_youtube_drum_pipeline",
                                                  REPO / "scripts" / "youtube_drum_pipeline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------------ multi-hot embeddings


def _multi_hot(rng, B, T, V) -> np.ndarray:
    hot = (rng.random((B, T, V)) < 0.05).astype(np.float32)
    hot[np.arange(B)[:, None], np.arange(T)[None], rng.integers(0, V, (B, T))] = 1.0  # at least one a row
    return hot


def test_multi_hot_decode_logits_match_jax():
    params, jcfg, model, _ = build(dict(BASE, plain=False))
    rng = np.random.default_rng(0)
    hot = _multi_hot(rng, 2, 7, BASE["tgt_vocab_size"])
    memory = (rng.normal(size=(2, 9, model.config.d_model)) * 0.5).astype(np.float32)
    ref = np.asarray(jadt.decode_logits(params, jnp.asarray(hot), jnp.asarray(memory), jcfg))
    with torch.no_grad():
        got = model.decode_logits(torch.from_numpy(hot), torch.from_numpy(memory))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_one_hot_rows_equal_the_id_path_and_ids_with_plain_false_raise():
    _, _, model, _ = build(BASE)
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, BASE["tgt_vocab_size"], (3, 6)))
    memory = torch.randn(3, 5, model.config.d_model, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        by_ids = model.decode_logits(ids, memory)
        by_rows = model.decode_logits(torch.nn.functional.one_hot(ids, BASE["tgt_vocab_size"]).float(), memory)
    torch.testing.assert_close(by_rows, by_ids, atol=1e-6, rtol=0)
    _, _, multi, _ = build(dict(BASE, plain=False))
    with pytest.raises(NotImplementedError, match="multi-hot"):
        multi.decode_logits(ids, memory)


# ------------------------------------------------------------------ host helpers


def test_get_matrix_equals_jax_dataframe():
    rng = np.random.default_rng(3)
    mapping = tmappings.ADTOF_LABEL_MAPPING
    ours, ref = tconf.DrumConfusionMatrix(mapping), jconf.DrumConfusionMatrix(mapping)
    for _ in range(6):
        on = np.round(rng.integers(0, 60, 12) * 0.01, 10)
        notes = np.stack([on, on + 0.1, rng.choice([35, 38, 42, 48, 61, 70], 12), rng.integers(1, 128, 12)], 1)
        pred = notes[: int(rng.integers(4, 12))].copy()
        pred[:, 0] += rng.normal(scale=0.02, size=len(pred))
        pred[::3, 2] = 41
        ours.update(notes, pred)
        ref.update(notes, pred)
    rows, cols, counts = ours.get_matrix()
    df = ref.get_matrix()
    assert rows == list(df.index) and cols == list(df.columns)
    np.testing.assert_array_equal(counts, df.values)
    assert counts.sum() > 0


def test_misc_helpers_equal_jax(tmp_path):
    files = [f"d/{c}.wav" for c in "qwertyuiop"]
    for seed_fix in (False, True):
        assert tmisc.file_shuffle(files, seed_fix) == jmisc.file_shuffle(files, seed_fix)
    a, b = np.arange(6.0).reshape(2, 3), np.ones((1, 3))
    for x, y in ((a, b), ([], b), (a, [])):
        np.testing.assert_array_equal(tmisc.my_vstack(x, y), jmisc.my_vstack(x, y))
    for x, y in ((np.arange(3.0), np.arange(5.0)), (np.arange(4.0), np.arange(2.0)), (np.ones(2), np.zeros(2))):
        for got, want in zip(tmisc.pad_arrays(x, y), jmisc.pad_arrays(x, y)):
            np.testing.assert_array_equal(got, want)
    values = [3, 1, 3, 2, 1, 5]
    assert [tmisc.get_random_mode(values, random.Random(s)) for s in range(8)] == \
        [jmisc.get_random_mode(values, random.Random(s)) for s in range(8)]
    np.testing.assert_array_equal(tmisc.create_one_hot(7, 4), jmisc.create_one_hot(7, 4))
    for side, mod in (("port", tmisc), ("jax", jmisc)):
        with h5py.File(tmp_path / f"{side}.hdf5", "w") as hf:
            for i in range(3):
                mod.save_to_hdf(hf, "kick", np.full(4, i, np.float32), np.arange(i + 2))
            mod.save_to_hdf(hf, None, np.zeros(2, np.float32), None)
            mod.save_to_hdf_variations(hf, "snare", np.ones(3, np.float32), [np.arange(k + 1) for k in range(3)])

    def dump(path):
        out = {}
        with h5py.File(path, "r") as hf:
            hf.visititems(lambda name, item: out.__setitem__(name, item[()].tolist())
                          if isinstance(item, h5py.Dataset) else None)
        return out

    assert dump(tmp_path / "port.hdf5") == dump(tmp_path / "jax.hdf5")
    assert "kick/seg2/midi" in dump(tmp_path / "port.hdf5")


def test_mapping_utils_equal_jax():
    assert vars(tmappings.MappingUtils()) == vars(jmappings.MappingUtils())


def test_render_segment_equals_jax():
    bank = make_test_bank(np.random.default_rng(3), PITCHES, sample_rate=8000, max_len=512)
    chunk, max_notes = 1280, 8
    rng = np.random.default_rng(4)
    on = rng.uniform(0, chunk / 8000, max_notes).astype(np.float32)
    notes = np.stack([on, on + 0.05, rng.choice(PITCHES, max_notes), rng.integers(1, 128, max_notes)],
                     1).astype(np.float32)
    mask = np.arange(max_notes) < 6
    key = jax.random.PRNGKey(9)
    js = jrender.SynthStatics.from_bank(bank)
    kw = dict(chunk_samples=chunk, sample_rate=8000, mixup_range=0.5, use_fx_prob=0.6, use_reverb_prob=1.0,
              use_compression_prob=0.5, use_limiter_prob=0.5, n_allowed=3, adtof=False)
    ref = np.asarray(jrender.render_segment(js, jnp.asarray(notes), jnp.asarray(mask), key, pallas="xla", **kw))
    draws = jax_render_draws(js, key[None], 3, False, 0.5, 0.6, (1.0, 0.5, 0.5))
    got = trender.render_segment(trender.SynthStatics.from_bank(bank, device="cpu"), torch.from_numpy(notes),
                                 torch.from_numpy(mask), draws, chunk, 8000, use_fx_prob=0.6)
    assert got.shape == (chunk,) and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=1e-3)


def test_inspect_hdf5_tree_and_cli_equal_jax(tmp_path):
    path = tmp_path / "tree.hdf5"
    with h5py.File(path, "w") as hf:
        for g, n in (("a/x", 2), ("a/y", 1), ("b", 3)):
            grp = hf.require_group(g)
            for i in range(n):
                grp.create_dataset(f"d{i}", data=np.arange(3))
        hf.create_dataset("top", data=np.zeros(1))
    with h5py.File(path, "r") as hf:
        assert tinspect.build_group_tree(hf) == jinspect.build_group_tree(hf)
    outs = [subprocess.run([sys.executable, "-m", mod, str(path), "--max-depth", "1"], capture_output=True,
                           text=True, check=True, cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu")).stdout
            for mod in ("adt_str_tpu_torch.utils.inspect_hdf5", "adt_str_tpu.utils.inspect_hdf5")]
    assert outs[0] == outs[1] and outs[0].startswith("/ (7 datasets)\n")


@pytest.fixture
def oneshot_dir(tmp_path):
    rng = np.random.default_rng(6)
    root = tmp_path / "oneshots"
    for pitch, sr in ((35, SR), (38, 2 * SR), (42, SR)):
        (root / str(pitch)).mkdir(parents=True)
        write_wav(root / str(pitch) / "a.wav", (rng.normal(size=int(0.2 * sr)) * 0.3).astype(np.float32), sr)
    return root


def test_drum_preview_midi_and_remap_equal_jax(tmp_path, oneshot_dir):
    rng = np.random.default_rng(7)
    n = 20
    on = rng.uniform(0, 1.4, n)
    notes = np.stack([on, on + rng.choice([0.0, 0.1], n), rng.choice([35, 38, 41, 42, 48, 61], n),
                      rng.choice([0.5, 1.0, 64.0, 127.0], n)], 1)
    for adtof in (False, True):
        got = tyt.remap_notes_for_synth(notes, adtof, np.random.default_rng(3))
        want = _jax_pipeline().remap_notes_for_synth(notes, adtof, np.random.default_rng(3))
        np.testing.assert_array_equal(got, want)
    synth = tyt.remap_notes_for_synth(notes, True, np.random.default_rng(3))
    for apply_mapping in (False, True):
        wav, kind = tdrum.render_drum_preview(synth, 6000, SR, tmp_path / "port.mid", str(oneshot_dir), apply_mapping)
        ref, _ = jdrum.render_drum_preview(synth, 6000, SR, tmp_path / "jax.mid", str(oneshot_dir), apply_mapping)
        assert kind == "oneshot" and wav.dtype == np.float32 and np.abs(wav).max() > 0.1
        np.testing.assert_array_equal(wav, ref)
        assert (tmp_path / "port.mid").read_bytes() == (tmp_path / "jax.mid").read_bytes()
    assert [tdrum.velocity_to_midi(v) for v in (0.0, 0.5, 1.0, 1.2, 300)] == \
        [jdrum.velocity_to_midi(v) for v in (0.0, 0.5, 1.0, 1.2, 300)]


# ------------------------------------------------------------------ the demo


def _config(hop_beam: dict | None = None, **sections) -> tuple[FrameworkConfig, JFrameworkConfig]:
    raw = tiny_config(inference={"max_length": 16, **(hop_beam or {})}, **sections)
    return FrameworkConfig.from_dict(raw), JFrameworkConfig.from_dict(raw)


@pytest.mark.parametrize("hop_sec", [None, 0.32])
def test_run_model_on_chunks_equals_jax(crafted, hop_sec):  # noqa: F811
    cfg, jcfg = _config()
    wav = (np.random.default_rng(8).normal(size=int(1.9 * SR)) * 0.1).astype(np.float32)
    model, tok = port_model(crafted, cfg), MidiTokenizer(cfg.tokenizer)
    got = tyt.run_model_on_chunks(model, cfg, tok, wav, hop_sec=hop_sec, device="cpu")
    ref = _jax_pipeline().run_model_on_chunks(crafted, jcfg, JMidiTokenizer(jcfg.tokenizer), wav, hop_sec=hop_sec)
    assert len(got) > 0
    np.testing.assert_array_equal(got, ref)
    starts, chunks = tyt.chunk_batch(cfg, wav, hop_sec)
    tokens = tyt.decode_chunks(model, cfg, tok, chunks, device="cpu")
    jtokens = np.asarray(jdecode.greedy_decode(crafted, jnp.asarray(chunks), jcfg.model, max_length=16,
                                               start_token=tok.BOS_token, end_token=tok.EOS_token))
    np.testing.assert_array_equal(tokens, jtokens)
    # each chunk decoded alone gives its row of the batch
    alone = greedy_decode(model, torch.from_numpy(chunks[-1:]), max_length=16, start_token=tok.BOS_token,
                          end_token=tok.EOS_token)
    np.testing.assert_array_equal(alone.numpy()[0], tokens[-1])


@pytest.fixture
def port_checkpoint(tmp_path, crafted):  # noqa: F811
    """The crafted weights written by the port's safetensors writer."""
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    write_safetensors(state_dict_from_jax_params(jax.tree.map(np.asarray, crafted)), ckpt / "model.safetensors")
    return ckpt


def _cli_yaml(tmp_path, ckpt) -> Path:
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(tiny_config(inference={"checkpoint_path": str(ckpt), "max_length": 16})))
    return path


@pytest.mark.parametrize("hop", [[], ["--hop-sec", "0.32"]], ids=["plain", "hop"])
def test_cli_writes_the_midi_and_the_preview(tmp_path, port_checkpoint, crafted, hop):  # noqa: F811
    wav = tmp_path / "song.wav"
    wave = (np.random.default_rng(9).normal(size=int(1.5 * SR)) * 0.1).astype(np.float32)
    write_wav(wav, wave, SR)
    cfg_path = _cli_yaml(tmp_path, port_checkpoint)
    out = tmp_path / "out"
    res = run_cli(["-m", "adt_str_tpu_torch.scripts.youtube_drum_pipeline", "--input-audio", str(wav), "--config",
                   str(cfg_path), "--output-dir", str(out), "--skip-demucs", "--device", "cpu", *hop])
    _, jcfg = _config()
    notes = _jax_pipeline().run_model_on_chunks(crafted, jcfg, JMidiTokenizer(jcfg.tokenizer),
                                                 jnormalize(jload(wav, SR)), hop_sec=0.32 if hop else None)
    assert f"Transcribed {len(notes)} notes" in res.stdout and len(notes) > 0
    synth = _jax_pipeline().remap_notes_for_synth(notes, True, np.random.default_rng(0))
    jdrum.save_drum_midi(synth, tmp_path / "want.mid")
    assert (out / "predicted_drums.mid").read_bytes() == (tmp_path / "want.mid").read_bytes()
    assert (out / "synthesized_drums.wav").stat().st_size > 44


def test_url_without_yt_dlp_and_separation_without_demucs_raise(tmp_path, port_checkpoint, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "empty-bin"))
    with pytest.raises(RuntimeError, match="yt-dlp not found"):
        tyt.download_youtube("video-id-placeholder", tmp_path / "dl")
    with pytest.raises(RuntimeError, match="demucs CLI not found"):
        tdemucs.separate_drums([str(tmp_path / "song.wav")], str(tmp_path / "sep"))
    with pytest.raises(RuntimeError, match="demucs CLI not found"):
        jdemucs.separate_drums([str(tmp_path / "song.wav")], str(tmp_path / "sep"))
    wav = tmp_path / "song.wav"
    write_wav(wav, np.zeros(SR, np.float32), SR)
    cfg_path = _cli_yaml(tmp_path, port_checkpoint)
    for args in (["--url", "video-id-placeholder"], ["--input-audio", str(wav)]):
        with pytest.raises(RuntimeError, match="yt-dlp not found" if "--url" in args else "demucs CLI not found"):
            tyt.main([*args, "--config", str(cfg_path), "--output-dir", str(tmp_path / "o"), "--device", "cpu"])
