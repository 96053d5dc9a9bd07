"""The port's evaluation slice on the CPU against the JAX package: the
per-item metrics and per-label counts, the confusion matrix's CSV bytes
(the port writes it without pandas), the ENST and MDB filters over one
synthetic parquet shard, `run_inference` (`metrics.json` equal and
`confusion_matrix.csv` byte-equal to the JAX harness's on the same weights
and shard) and the eval CLI end to end in a subprocess against `eval.py`.

The tiny model's generator is crafted (`crafted_params`) so that greedy
decoding emits four notes a chunk whatever the audio: random weights emit
none, and the matchers would then see only false negatives.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch
import yaml

import jax

from adt_str_tpu.config import EvalDataConfig as JEvalDataConfig
from adt_str_tpu.config import FrameworkConfig as JFrameworkConfig
from adt_str_tpu.config import InferenceConfig as JInferenceConfig
from adt_str_tpu.data import datasets as jdata
from adt_str_tpu.domain.tokenizer import MidiTokenizer as JMidiTokenizer
from adt_str_tpu.evaluation import confusion as jconf
from adt_str_tpu.evaluation import harness as jharness
from adt_str_tpu.evaluation import metrics as jmetrics
from adt_str_tpu.models import adt as jadt
from adt_str_tpu.training.checkpoint import export_safetensors
from adt_str_tpu_torch.config import EvalDataConfig, FrameworkConfig, InferenceConfig
from adt_str_tpu_torch.data import datasets as tdata
from adt_str_tpu_torch.domain.tokenizer import MidiTokenizer
from adt_str_tpu_torch.evaluation import confusion as tconf
from adt_str_tpu_torch.evaluation import harness as tharness
from adt_str_tpu_torch.evaluation import metrics as tmetrics
from adt_str_tpu_torch.models.adt import ADTModel
from adt_str_tpu_torch.models.convert import state_dict_from_jax_params
from adt_str_tpu_torch.utils.mappings import ADTOF_LABEL_MAPPING, GM_REDUCED_NAME_CONVENTION

REPO = Path(__file__).resolve().parent.parent
SR = 4000
SHARED = {"input_sec": 0.64, "time_res": 0.01, "win_length": 256, "sample_rate": SR}
MODEL = {"enc_layers": 1, "dec_layers": 1, "nhead": 2, "d_query": 16, "dropout": 0.0, "tgt_vocab_size": 1400,
         "n_mels": 16, "compute_dtype": "float32", "max_positions": 64}
TOKENIZER = {"ADTOF_mapping": True, "BOS_token": 2, "EOS_token": 3, "pad_token": 1, "silence_token": 0,
             "add_velocity": True}
# the token cycle the crafted generator follows: four (time, pitch, velocity)
# notes at 0.10, 0.25, 0.40 and 0.55 s on pitches 35, 38, 42 and 48, then EOS
CYCLE = [2, 14, 335, 480, 29, 338, 490, 44, 342, 500, 59, 348, 510, 3]


def tiny_config(adtof: bool = True, **sections) -> dict:
    return {"shared": dict(SHARED), "model": dict(MODEL), "tokenizer": dict(TOKENIZER, ADTOF_mapping=adtof),
            **sections}


def crafted_params():
    """JAX params of the tiny model whose generator maps each token of CYCLE
    to the next: its column for token b is the centred embedding of the
    token before b, so the decoder's output, dominated by the current
    token's embedding, scores the next token of the cycle highest."""
    params = jadt.init_params(jax.random.PRNGKey(2), JFrameworkConfig.from_dict(tiny_config()).model)
    emb = np.asarray(params["decoder"]["embedding"])
    w = np.array(params["decoder"]["generator"]["w"])  # (d, vocab)
    for a, b in zip(CYCLE[:-1], CYCLE[1:]):
        e = emb[a] - emb[a].mean()
        w[:, b] = 5.0 * e / np.linalg.norm(e)
    params["decoder"]["generator"]["w"] = w
    return params


def port_model(params, cfg) -> ADTModel:
    model = ADTModel(cfg.model, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params)), strict=True)
    return model


@pytest.fixture(scope="module")
def crafted():
    return crafted_params()


@pytest.fixture(scope="module")
def checkpoint_dir(tmp_path_factory, crafted):
    """The crafted weights as the JAX package exports them (reference-named safetensors)."""
    ckpt = tmp_path_factory.mktemp("ckpt")
    export_safetensors(crafted, ckpt / "model.safetensors")
    return str(ckpt)


# ------------------------------------------------------------------ metrics


def _random_notes(rng, n, pitches):
    on = np.round(rng.integers(0, 60, n) * 0.01, 10)
    return np.stack([on, on + 0.1, rng.choice(pitches, n), rng.integers(1, 128, n)], 1).astype(np.float64)


@pytest.mark.parametrize("exclude_ref_empty", [False, True])
def test_metrics_and_per_label_counts_equal_jax(exclude_ref_empty):
    rng = np.random.default_rng(3)
    pitches = [35, 38, 41, 42, 48, 52, 58, 61, 70]
    ours, ref = tmetrics.new_per_label_accumulator(), jmetrics.new_per_label_accumulator()
    totals = np.zeros(3, int)
    for _ in range(40):
        gt = _random_notes(rng, int(rng.integers(0, 12)), pitches)
        est = _random_notes(rng, int(rng.integers(0, 12)), pitches)
        gt_arg = gt if len(gt) else []
        got = tmetrics.compute_metrics(gt_arg, est, exclude_ref_empty)
        assert got == jmetrics.compute_metrics(gt_arg, est, exclude_ref_empty)
        totals += got
        ours = tmetrics.compute_per_label_metrics(est, gt_arg, ours, exclude_ref_empty)
        ref = jmetrics.compute_per_label_metrics(est, gt_arg, ref, exclude_ref_empty)
    assert totals[0] > 0 and totals[1] > 0 and totals[2] > 0
    assert json.dumps(ours) == json.dumps(ref)
    assert tmetrics.aggregate_metrics(*totals) == jmetrics.aggregate_metrics(*totals)
    assert tmetrics.aggregate_metrics(0, 0, 0) == jmetrics.aggregate_metrics(0, 0, 0)


@pytest.mark.parametrize("exclude_ref_empty", [False, True])
@pytest.mark.parametrize("table", ["adtof", "gm"])
def test_confusion_csv_bytes_equal_jax(tmp_path, table, exclude_ref_empty):
    mapping = ADTOF_LABEL_MAPPING if table == "adtof" else GM_REDUCED_NAME_CONVENTION
    ours, ref = tconf.DrumConfusionMatrix(mapping), jconf.DrumConfusionMatrix(mapping)
    assert ours.labels == ref.labels
    rng = np.random.default_rng(4)
    pitches = [*mapping, 30, 99]  # and pitches outside the table ("Other")
    for _ in range(30):
        gt = _random_notes(rng, int(rng.integers(0, 10)), pitches)
        est = _random_notes(rng, int(rng.integers(0, 10)), pitches)
        for m in (ours, ref):
            m.update(gt if len(gt) else [], est, exclude_ref_empty=exclude_ref_empty)
    ours.to_csv(tmp_path / "ours.csv")
    ref.to_csv(tmp_path / "ref.csv")
    assert (tmp_path / "ours.csv").read_bytes() == (tmp_path / "ref.csv").read_bytes()
    # the empty matrix too
    tconf.DrumConfusionMatrix(mapping).to_csv(tmp_path / "e1.csv")
    jconf.DrumConfusionMatrix(mapping).to_csv(tmp_path / "e2.csv")
    assert (tmp_path / "e1.csv").read_bytes() == (tmp_path / "e2.csv").read_bytes()


# ----------------------------------------------------------------- datasets

ENST_TRACKS = ["107_minus-one_salsa_sticks", "152_MIDI-minus-one_fusion-125_sticks", "126_minus-one_salsa_sticks",
               "001_hits_snare_sticks", "144_MIDI-minus-one_rock-113_sticks", "012_phrase_rock_simple_slow_sticks",
               "162_MIDI-minus-one_fusion-125_sticks", "131_minus-one_funk_sticks", "002_hits_kick",
               "115_minus-one_bossa_brushes"]


def write_shard(path, rng, pred_notes=None):
    """One parquet shard with both datasets' columns: ten items over three
    drummers, MDB folds 0-2 and the demucs flag, two at twice the sample
    rate, one with an empty reference, short items (the last two, below 1024
    samples together, form a batch the harness skips at batch size 2).
    References are GM-standard notes near `pred_notes` (local seconds and
    ADTOF classes of what the crafted model emits), some shifted to the
    50 ms boundary, some on another pitch, plus random ones."""
    gm_of_class = {35: 35, 38: 38, 41: 41, 42: 42, 48: 51, 52: 56, 58: 75, 61: 58}
    rows = {k: [] for k in ("audio_id", "drummer", "audio", "sample_rate", "notes", "split", "is_demucs_separated")}
    for i, track in enumerate(ENST_TRACKS):
        sr = 2 * SR if i in (2, 5) else SR
        n = {8: 400, 9: 500, 4: int(0.3 * sr)}.get(i, int(0.64 * sr))
        notes = []
        if i != 3 and pred_notes is not None:
            for on, _, cls, vel in pred_notes:
                if rng.random() < 0.2:
                    continue
                shift = rng.choice([0.0, 0.0, 0.03, 0.05, -0.05, 0.06])
                pitch = gm_of_class[int(cls)] if rng.random() < 0.7 else int(rng.choice([35, 38, 42, 46, 49]))
                notes.append([on + shift, on + shift + 0.05, pitch, vel])
            for _ in range(int(rng.integers(0, 3))):
                on = rng.uniform(0, 0.6)
                notes.append([on, on + 0.05, int(rng.choice([36, 38, 45, 51, 56, 75])), int(rng.integers(1, 128))])
        rows["audio_id"].append(f"drummer_{i % 3 + 1}/{track}.wav")
        rows["drummer"].append(f"drummer_{i % 3 + 1}")
        rows["audio"].append((rng.normal(size=n) * 0.2).astype(np.float32).tobytes())
        rows["sample_rate"].append(sr)
        rows["notes"].append(np.asarray(notes, np.float32).reshape(-1, 4).tobytes())
        rows["split"].append(i % 3)
        rows["is_demucs_separated"].append(i in (1, 6))
    schema = pa.schema([("audio_id", pa.string()), ("drummer", pa.string()), ("audio", pa.binary()),
                        ("sample_rate", pa.int32()), ("notes", pa.binary()), ("split", pa.int32()),
                        ("is_demucs_separated", pa.bool_())])
    pq.write_table(pa.table(rows, schema=schema), path)


@pytest.fixture(scope="module")
def shard(tmp_path_factory, crafted):
    """The shard, with references near the crafted model's notes."""
    from adt_str_tpu_torch.evaluation.notes import decode_tokens_to_notes

    cfg = FrameworkConfig.from_dict(tiny_config())
    tokens = torch.tensor(CYCLE)
    pred = decode_tokens_to_notes(MidiTokenizer(cfg.tokenizer), tokens.numpy())
    assert pred.shape == (4, 4)
    path = tmp_path_factory.mktemp("shard") / "eval.parquet"
    write_shard(path, np.random.default_rng(11), pred)
    return str(path)


DATASET_CASES = [
    ("ENST", {}), ("ENST", {"minus_one": True}), ("ENST", {"splits": [0]}), ("ENST", {"splits": 2}),
    ("ENST", {"minus_one": True, "splits": [1, 2], "drummers": [1, 2]}), ("ENST", {"drummers": [3]}),
    ("MDB", {}), ("MDB", {"splits": [0]}), ("MDB", {"splits": [1, 2]}), ("MDB", {"demucs_separated": True}),
]


@pytest.mark.parametrize("name, filters", DATASET_CASES, ids=[f"{n}-{f}" for n, f in DATASET_CASES])
def test_dataset_filters_select_the_same_items_as_jax(shard, name, filters):
    kw = dict(dataset_path=shard, dataset_name=name, sample_rate=SR, input_sec=0.64, **filters)
    tok, jtok = MidiTokenizer(FrameworkConfig.from_dict(tiny_config()).tokenizer), \
        JMidiTokenizer(JFrameworkConfig.from_dict(tiny_config()).tokenizer)
    cls = {"ENST": (tdata.ENSTDataset, jdata.ENSTDataset), "MDB": (tdata.MDBDataset, jdata.MDBDataset)}[name]
    ours, ref = cls[0](EvalDataConfig(**kw), tok), cls[1](JEvalDataConfig(**kw), jtok)
    assert ours.data == ref.data
    assert 0 < len(ours) == len(ref)
    for a, b in zip(ours.batches(3), ref.batches(3)):
        for key in ("wavs", "notes"):
            assert len(a[key]) == len(b[key])
            for x, y in zip(a[key], b[key]):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


def test_missing_pyarrow_names_the_package(monkeypatch, shard):
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    with pytest.raises(ImportError, match="pyarrow"):
        tdata.ENSTDataset(EvalDataConfig(dataset_path=shard), MidiTokenizer(FrameworkConfig.from_dict(tiny_config()).tokenizer))


def test_trim_note_bucket_equals_jax():
    rng = np.random.default_rng(5)
    for hi in (0, 1, 15, 16, 17, 39, 48, 128):
        mask = np.zeros((4, 128), bool)
        mask[rng.integers(0, 4), :hi] = True
        notes = rng.normal(size=(4, 128, 4)).astype(np.float32)
        got, ref = tdata.trim_note_bucket({"notes": notes, "note_mask": mask}), \
            jdata.trim_note_bucket({"notes": notes, "note_mask": mask})
        assert got.keys() == ref.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], ref[k])
    assert tdata.trim_note_bucket({"tokens": 1}) == {"tokens": 1}


# -------------------------------------------------------------- the harness

HARNESS_CASES = [("ENST", True, False, None, {"minus_one": False}), ("MDB", False, True, 5, {"splits": [0, 1, 2]})]


@pytest.mark.parametrize("name, adtof, exclude, max_samples, filters", HARNESS_CASES,
                         ids=["enst-adtof", "mdb-gm-exclude-max5"])
def test_run_inference_writes_what_the_jax_harness_writes(tmp_path, crafted, shard, name, adtof, exclude,
                                                          max_samples, filters):
    raw = tiny_config(adtof)
    cfg, jcfg = FrameworkConfig.from_dict(raw), JFrameworkConfig.from_dict(raw)
    kw = dict(dataset_path=shard, dataset_name=name, sample_rate=SR, input_sec=0.64, **filters)
    cls = {"ENST": (tdata.ENSTDataset, jdata.ENSTDataset), "MDB": (tdata.MDBDataset, jdata.MDBDataset)}[name]
    tok, jtok = MidiTokenizer(cfg.tokenizer), JMidiTokenizer(jcfg.tokenizer)
    inf = dict(batch_size=2, max_length=16, use_beam_search=False, max_samples=max_samples)
    got = tharness.run_inference(port_model(crafted, cfg), cfg.model, cls[0](EvalDataConfig(**kw), tok), tok,
                                 InferenceConfig(**inf, output_path=str(tmp_path / "port")), exclude, device="cpu")
    ref = jharness.run_inference(crafted, jcfg.model, cls[1](JEvalDataConfig(**kw), jtok), jtok,
                                 JInferenceConfig(**inf, output_path=str(tmp_path / "jax")), exclude)
    assert got == ref
    assert 0 < ref["all"]["precision"] < 1 and 0 < ref["all"]["recall"] < 1
    for f in ("metrics.json", "confusion_matrix.csv"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_run_inference_refuses_beam_search_and_a_mesh(crafted, shard):
    cfg = FrameworkConfig.from_dict(tiny_config())
    model, tok = port_model(crafted, cfg), MidiTokenizer(cfg.tokenizer)
    ds = tdata.ENSTDataset(EvalDataConfig(dataset_path=shard, sample_rate=SR), tok)
    # beam search is ported: it decodes (test_torch_beam.py holds its metrics to the JAX harness's)
    beam = tharness.run_inference(model, cfg.model, ds, tok, InferenceConfig(use_beam_search=True, max_length=8,
                                                                            output_path=""), device="cpu")
    assert set(beam["all"]) == {"precision", "recall", "f_measure"}
    with pytest.raises(NotImplementedError, match="item 10"):
        tharness.run_inference(model, cfg.model, ds, tok, InferenceConfig(), device="cpu", mesh=object())


# ------------------------------------------------------------------ the CLI


def run_cli(args, cwd=REPO):
    """A CLI in a subprocess on the CPU (one JAX device)."""
    flags = " ".join(f for f in os.environ.get("XLA_FLAGS", "").split() if "device_count" not in f)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags)
    proc = subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def test_eval_cli_writes_what_eval_py_writes(tmp_path, checkpoint_dir, shard):
    outputs = {}
    for side in ("port", "jax"):
        out = tmp_path / side
        raw = tiny_config(
            EvalDatasetConfig={"dataset_path": shard, "dataset_name": "ENST", "minus_one": True, "splits": None,
                               "drummers": None},
            inference={"checkpoint_path": checkpoint_dir, "batch_size": 2, "max_length": 16,
                       "use_beam_search": False, "output_path": str(out)},
            logging={"log_level": "INFO"},
        )
        path = tmp_path / f"{side}.yaml"
        path.write_text(yaml.safe_dump(raw))
        if side == "port":
            proc = run_cli(["-m", "adt_str_tpu_torch.eval", str(path), "-e", "--device", "cpu"])
        else:
            proc = run_cli(["eval.py", str(path), "-e"])
        assert "F1-Score" in proc.stderr
        outputs[side] = {f: (out / f).read_bytes() for f in ("metrics.json", "confusion_matrix.csv")}
    assert outputs["port"] == outputs["jax"]
    assert json.loads(outputs["port"]["metrics.json"])["all"]["recall"] > 0


@pytest.mark.parametrize("path", ["configs/eval/ENSTinference.yaml", "configs/eval/MDBinference.yaml"])
def test_eval_configs_parse_alike_with_their_dataset_section(path, monkeypatch):
    """Both eval configs through the port's own reader (PyYAML blocked, as
    on the machine with the card) give the JAX package's typed sections,
    `EvalDatasetConfig` included."""
    ref = JFrameworkConfig.from_yaml(REPO / path)
    monkeypatch.setitem(sys.modules, "yaml", None)
    cfg = FrameworkConfig.from_yaml(REPO / path)
    assert dataclasses.asdict(cfg.eval_data) == dataclasses.asdict(ref.eval_data)
    assert cfg.eval_data.dataset_name == Path(path).name.removesuffix("inference.yaml")
    for section in ("shared", "tokenizer", "model", "inference"):
        assert dataclasses.asdict(getattr(cfg, section)) == dataclasses.asdict(getattr(ref, section)), section
    assert cfg.synthetiser is None and ref.synthetiser is None


def test_port_imports_none_of_the_packages_the_card_lacks():
    """Importing every port module and chip_smoke.py loads none of pandas,
    pyarrow, h5py, PyYAML or safetensors (the card's machine has none of
    them): the eval datasets and the bank file import theirs where they read."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import adt_str_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('pandas', 'pyarrow', 'h5py', 'yaml', 'safetensors'))\n"
        "assert not bad, bad\n"
        "print(sorted(m for m in sys.modules if m.startswith('adt_str_tpu_torch.')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for module in ("eval", "inference", "bench", "data.datasets", "evaluation.harness", "ops.matching"):
        assert f"'adt_str_tpu_torch.{module}'" in out.stdout, module
