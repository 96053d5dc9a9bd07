"""The port's serving slice on the CPU: the engine is a pure batching layer
(tokens equal a direct port decode; notes equal the JAX engine's on the same
weights), the HTTP front-end round-trips, configs parse alike in both
packages, the port imports no JAX, and entry points never fall back to the
CPU on their own.
"""

import dataclasses
import json
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from adt_str_tpu.config import FrameworkConfig as JFrameworkConfig
from adt_str_tpu.domain.tokenizer import MidiTokenizer as JMidiTokenizer
from adt_str_tpu.models import adt as jadt
from adt_str_tpu.serving.engine import ServingEngine as JServingEngine
from adt_str_tpu_torch import resolve_device
from adt_str_tpu_torch.config import FrameworkConfig
from adt_str_tpu_torch.domain.tokenizer import MidiTokenizer
from adt_str_tpu_torch.evaluation.notes import decode_tokens_to_notes, merge_chunk_notes
from adt_str_tpu_torch.models import decode as tdecode
from adt_str_tpu_torch.models.adt import ADTModel
from adt_str_tpu_torch.models.convert import load_reference_checkpoint, state_dict_from_jax_params
from adt_str_tpu_torch.serve import build_engine
from adt_str_tpu_torch.serving.engine import ServingEngine
from adt_str_tpu_torch.serving.http import make_server, start_in_thread

REPO = Path(__file__).resolve().parent.parent
TINY = {
    "shared": {"input_sec": 0.64, "time_res": 0.01, "win_length": 256, "sample_rate": 4000},
    "model": {"enc_layers": 1, "dec_layers": 1, "nhead": 2, "d_query": 16, "dropout": 0.0,
              "tgt_vocab_size": 1400, "n_mels": 16, "compute_dtype": "float32", "max_positions": 64},
    "tokenizer": {"ADTOF_mapping": False, "BOS_token": 2, "EOS_token": 3, "pad_token": 1,
                  "silence_token": 0, "add_velocity": True},
    "inference": {"max_length": 10, "batch_size": 4},
}


@pytest.fixture(scope="module")
def served():
    """(JAX params, port model, port config): one tiny model on the same
    weights, generator scaled so greedy emits varied tokens."""
    cfg = FrameworkConfig.from_dict(TINY)
    params = jadt.init_params(jax.random.PRNGKey(2), JFrameworkConfig.from_dict(TINY).model)
    params["decoder"]["generator"]["w"] = params["decoder"]["generator"]["w"] * 4.0
    model = ADTModel(cfg.model, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params)), strict=True)
    return params, model, cfg


def _chunks(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, cfg.shared.chunk_samples)) * 0.3).astype(np.float32)


def test_engine_tokens_match_direct_decode(served):
    """3 chunks through the engine (bucket-padded to 4) equal a direct port
    greedy_decode of the bare 3-row batch: padding rows are inert."""
    _, model, cfg = served
    waves = _chunks(cfg, 3)
    direct = tdecode.greedy_decode(model, torch.from_numpy(waves), max_length=cfg.inference.max_length).numpy()
    with ServingEngine(model, cfg, device="cpu", buckets=(1, 2, 4, 8)) as eng:
        got = np.stack([f.result(timeout=120) for f in [eng.submit_chunk(w) for w in waves]])
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, direct)


@pytest.mark.parametrize("hop_sec", [None, 0.32])
def test_engine_transcribe_matches_jax_engine(served, hop_sec):
    """Whole-song transcription (non-chunk-aligned tail; plain and
    overlapping hop) equals the JAX engine's on the same weights: the same
    chunk tokens and the same merged notes."""
    params, model, cfg = served
    rng = np.random.default_rng(7)
    wave = (rng.normal(size=3 * cfg.shared.chunk_samples - 64) * 0.3).astype(np.float32)
    chunks = _chunks(cfg, 3, seed=8)
    with JServingEngine(params, JFrameworkConfig.from_dict(TINY), buckets=(1, 2, 4, 8)) as eng:
        ref = eng.transcribe(wave, hop_sec=hop_sec)
        ref_tokens = [np.asarray(f.result(timeout=120)) for f in [eng.submit_chunk(c) for c in chunks]]
    with ServingEngine(model, cfg, device="cpu", buckets=(1, 2, 4, 8)) as eng:
        got = eng.transcribe(wave, hop_sec=hop_sec)
        tokens = [f.result(timeout=120) for f in [eng.submit_chunk(c) for c in chunks]]
    assert got.dtype == np.float64 and got.shape[1:] == (4,)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(np.stack(tokens), np.stack(ref_tokens))


@pytest.mark.parametrize("snap", [False, True])
def test_chunk_notes_merge_matches_jax(snap):
    """Tokens -> notes -> time shift -> merge on crafted token rows (random
    weights rarely emit time/pitch pairs): float64 notes equal the JAX
    harness's, with and without the overlap-hop grid snap."""
    from adt_str_tpu.evaluation import harness

    tcfg = FrameworkConfig.from_dict(TINY).tokenizer
    ttok, jtok = MidiTokenizer(tcfg), JMidiTokenizer(JFrameworkConfig.from_dict(TINY).tokenizer)
    rng = np.random.default_rng(9)
    rows = []
    for _ in range(4):
        n = int(rng.integers(1, 8))
        notes = np.stack([rng.integers(4, 300, n), rng.integers(335, 352, n), rng.integers(400, 528, n)], 1)
        rows.append(np.concatenate([[2], notes.reshape(-1), [3, 3]]))
    rows.append(rows[0].copy())  # a duplicate chunk: the merge dedups it
    starts = [0.0, 0.32, 0.64, 0.96, 0.0]
    out, ref = [], []
    for start, row in zip(starts, rows):
        a = decode_tokens_to_notes(ttok, row)
        b = harness.decode_tokens_to_notes(jtok, row)
        a[:, 0:2] += start
        b[:, 0:2] += start
        out.append(a)
        ref.append(b)
    got = merge_chunk_notes(out, snap_to_grid=snap)
    assert len(got) and got.dtype == np.float64
    np.testing.assert_array_equal(got, harness.merge_chunk_notes(ref, snap_to_grid=snap))


@pytest.mark.parametrize("adtof", [False, True])
def test_tokens_to_notes_match_jax(adtof):
    """The port's pure-Python decode equals the JAX tokenizer's decode
    (native or Python) on random token rows, quirks included."""
    tcfg = dataclasses.replace(FrameworkConfig.from_dict(TINY).tokenizer, ADTOF_mapping=adtof)
    jtok = JMidiTokenizer(JFrameworkConfig.from_dict({"tokenizer": dataclasses.asdict(tcfg)}).tokenizer)
    ttok = MidiTokenizer(tcfg)
    rng = np.random.default_rng(5)
    for _ in range(50):
        row = rng.integers(0, 600, size=int(rng.integers(0, 40)))
        np.testing.assert_array_equal(ttok.decode(row).reshape(-1, 4), jtok.decode(row).reshape(-1, 4))
        np.testing.assert_array_equal(ttok.truncate_at_eos(row), jtok.truncate_at_eos(row))


def test_engine_close_drains_pending(served):
    _, model, cfg = served
    eng = ServingEngine(model, cfg, device="cpu", buckets=(1, 2, 4))
    futs = [eng.submit_chunk(w) for w in _chunks(cfg, 5)]
    eng.close()
    for f in futs:
        assert f.result(timeout=120).shape == (cfg.inference.max_length,)
    with pytest.raises(RuntimeError):
        eng.submit_chunk(_chunks(cfg, 1)[0])


def test_engine_rejects_what_is_not_ported(served):
    _, model, cfg = served
    with ServingEngine(model, cfg, device="cpu", use_beam=True, beam_size=2) as eng:  # beam search is ported
        assert eng.use_beam and eng.beam_size == 2
    # multi-device decode is ported (test_torch_decode_dp.py): the mesh must be a DataMesh of this process
    with pytest.raises(ValueError, match="DataMesh"):
        ServingEngine(model, cfg, device="cpu", mesh=object())
    with pytest.raises(ValueError):
        ServingEngine(model, cfg, device="cpu", buckets=(4, 2))
    raw = dict(TINY, serving={"buckets": [2, 4], "max_wait_ms": 0.0})
    with build_engine(FrameworkConfig.from_dict(raw), model, "cpu") as eng:
        assert eng.buckets == (2, 4) and eng.max_wait_s == 0.0
        with pytest.raises(ValueError):
            eng.submit_chunk(np.zeros(cfg.shared.chunk_samples + 1, np.float32))


def _request(url, body=None, method="POST"):
    req = urllib.request.Request(url, data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def test_http_round_trip(served):
    """POST raw f32 PCM -> the notes `engine.transcribe` gives; MIDI format;
    health, stats and error paths."""
    _, model, cfg = served
    eng = build_engine(cfg, model, "cpu")
    server = make_server(eng, "127.0.0.1", 0)
    start_in_thread(server)
    base = "http://%s:%d" % server.server_address[:2]
    try:
        wave = (np.random.default_rng(11).normal(size=2 * cfg.shared.chunk_samples) * 0.3).astype(np.float32)
        status, ctype, body = _request(base + "/v1/transcribe", wave.tobytes())
        assert status == 200 and ctype == "application/json", body
        payload = json.loads(body)
        expect = eng.transcribe(wave)
        np.testing.assert_array_equal(np.asarray(payload["notes"], np.float64).reshape(-1, 4), expect)
        assert payload["n_notes"] == len(expect)
        status, ctype, body = _request(base + "/v1/transcribe?format=midi", wave.tobytes())
        assert status == 200 and ctype == "audio/midi" and body[:4] == b"MThd"
        status, _, body = _request(base + "/healthz", method="GET")
        assert status == 200 and json.loads(body)["ok"] is True
        status, _, body = _request(base + "/stats", method="GET")
        assert json.loads(body)["n_requests"] >= 2
        status, _, body = _request(base + "/v1/transcribe", b"abc")
        assert status == 400 and b"float32" in body
        assert _request(base + "/nope", b"\x00" * 4)[0] == 404
    finally:
        server.shutdown()
        server.server_close()
        eng.close()


def test_serve_cli_round_trip(served, tmp_path):
    """`python -m adt_str_tpu_torch.serve <yaml> --device cpu`: loads the
    checkpoint the YAML names, warms its buckets, answers a POST, and drains
    and exits 0 on SIGTERM."""
    import queue
    import signal
    import threading

    import yaml

    from adt_str_tpu.training.checkpoint import export_safetensors

    params, _, cfg = served
    export_safetensors(params, tmp_path / "model.safetensors")
    raw = dict(TINY, inference={"max_length": 10, "checkpoint_path": str(tmp_path)},
               serving={"buckets": [1, 2, 4], "port": 0})
    (tmp_path / "serve.yaml").write_text(yaml.safe_dump(raw))
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "adt_str_tpu_torch.serve", str(tmp_path / "serve.yaml"), "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(l) for l in proc.stdout], daemon=True).start()
    try:
        line = ""
        while "Serving on" not in line:
            line = lines.get(timeout=120)
        base = line.split("Serving on ")[1].split()[0]
        wave = _chunks(cfg, 1, seed=4)[0]
        status, _, body = _request(base + "/v1/transcribe", wave.tobytes())
        assert status == 200 and {"notes", "n_notes", "duration_sec"} <= set(json.loads(body))
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def _typed(cfg) -> dict:
    return {s: dataclasses.asdict(getattr(cfg, s)) for s in ("shared", "tokenizer", "model", "inference", "serving")}


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(REPO)) for d in ("eval", "serve") for p in (REPO / "configs" / d).glob("*.yaml"))
)
def test_configs_parse_alike_in_both_packages(path):
    assert _typed(FrameworkConfig.from_yaml(REPO / path)) == _typed(JFrameworkConfig.from_yaml(REPO / path))


def test_chip_smoke_config_is_enst_serving(monkeypatch):
    """chip_smoke.py reads configs/serve/ENSTserving.yaml with the port's own
    reader (the machine with the card has no PyYAML): with PyYAML blocked it
    gives the JAX package's typed config."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    assert chip_smoke.SERVING_YAML == "configs/serve/ENSTserving.yaml"
    jax_cfg = JFrameworkConfig.from_yaml(REPO / chip_smoke.SERVING_YAML)
    monkeypatch.setitem(sys.modules, "yaml", None)
    cfg = chip_smoke.load_config(chip_smoke.SERVING_YAML)
    assert _typed(cfg) == _typed(jax_cfg)
    assert cfg.model.use_pallas_mel and cfg.model.use_flash_attention


def test_port_imports_no_jax():
    """Importing every port module (and chip_smoke.py) leaves `jax` and the
    JAX package out of sys.modules; the training job's modules are among
    those imported."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import adt_str_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'adt_str_tpu'))\n"
        "assert not bad, bad\n"
        "new = ['training.trainer', 'training.checkpoint', 'data.datasets', 'train', 'utils.misc', 'parallel.mesh',\n"
        "       'parallel.train_step', 'models.decode', 'serving.engine', 'evaluation.harness', 'inference', 'eval',\n"
        "       'serve', 'clap.features', 'clap.audio_model', 'clap.text_model', 'clap.model', 'clap.convert',\n"
        "       'clap.curation', 'scripts.augment_data_with_clap', 'scripts.copy_originals_to_augmented',\n"
        "       'scripts.convert_augmented_to_hdf5', 'scripts.midi_parser', 'scripts.text_parser', 'data.lakh',\n"
        "       'data.parsers', 'utils.midi_utils', 'ops.layer_norm', 'ops.linear', 'ops.attention_rows',\n"
        "       'scripts.export_serving']\n"
        "missing = [m for m in new if 'adt_str_tpu_torch.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print(len([m for m in sys.modules if m.startswith('adt_str_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_entry_points_need_a_device_without_cuda(served, monkeypatch, tmp_path):
    """With no CUDA and no device argument, entry points raise; they never
    fall back to the CPU on their own."""
    _, model, cfg = served
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA"):
        ADTModel(cfg.model)
    with pytest.raises(RuntimeError, match="no CUDA"):
        ServingEngine(model, cfg)
    with pytest.raises(RuntimeError, match="no CUDA"):
        build_engine(cfg, model)
    with pytest.raises(RuntimeError, match="no CUDA"):
        load_reference_checkpoint(tmp_path)
