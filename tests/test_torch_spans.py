"""The port's spans and counters (`adt_str_tpu_torch/utils/spans.py`) on the
CPU: off, nothing is kept; on, records nest with parents, self times and
ids, one request's spans on two threads share its id, and a profiler
session holds one annotation per record; the decode loops, the synthesis
training step, the serving engine and the kernel build record their
boundaries without changing what they compute, and `GreedyProgram`
exports the same graph with spans on.
"""

import json
import stat
import threading
import time

import numpy as np
import pytest
import torch

from adt_str_tpu_torch.config import FrameworkConfig, ModelConfig, SynthConfig, TrainingConfig
from adt_str_tpu_torch.models import decode as tdecode
from adt_str_tpu_torch.models.adt import ADTModel, draw_site_keys
from adt_str_tpu_torch.ops import _build
from adt_str_tpu_torch.parallel import train_step as tstep
from adt_str_tpu_torch.scripts import export_serving as texport
from adt_str_tpu_torch.serving.engine import ServingEngine
from adt_str_tpu_torch.synth import render as trender
from adt_str_tpu_torch.synth.bank import make_test_bank
from adt_str_tpu_torch.training.optimizer import make_optimizer
from adt_str_tpu_torch.utils import spans

TINY = {
    "shared": {"input_sec": 0.64, "time_res": 0.01, "win_length": 256, "sample_rate": 4000},
    "model": {"enc_layers": 1, "dec_layers": 1, "nhead": 2, "d_query": 16, "dropout": 0.0,
              "tgt_vocab_size": 40, "n_mels": 16, "compute_dtype": "float32", "max_positions": 64},
    "inference": {"max_length": 10, "batch_size": 4},
}
SR, CHUNK_SEC, L = 4000, 0.64, 512
SYNTH = dict(sample_rate=SR, input_sec=CHUNK_SEC, win_length=256, time_res=0.01, similarity_threshold=0.8,
             mixup_range=0.8, use_fx_prob=0.6, max_notes=16, max_oneshot_sec=L / SR)
EOS = 3


@pytest.fixture(autouse=True)
def fresh_spans():
    spans.enable(False)
    spans.reset()
    yield
    spans.enable(False)
    spans.reset()


def _named(records, name):
    return [r for r in records if r["name"] == name]


def _model(seed=0, eos_bias=None):
    """The tiny serving model; `eos_bias` set on the generator's EOS logit
    keeps every row decoding to the last step."""
    model = ADTModel(FrameworkConfig.from_dict(TINY).model, seed=seed, device="cpu")
    if eos_bias is not None:
        with torch.no_grad():
            model.decoder.generator.bias[EOS] = eos_bias
    return model.eval()


def _waves(n, seed=0):
    cfg = FrameworkConfig.from_dict(TINY)
    return (np.random.default_rng(seed).normal(size=(n, cfg.shared.chunk_samples)) * 0.3).astype(np.float32)


def test_the_off_path_records_nothing():
    assert not spans._on
    with spans.span("decode.step", step=1) as s:
        spans.count("kernels.built")
    assert s is spans.span("serve.batch")  # one shared no-op
    snap = spans.snapshot()
    assert snap["spans"] == [] and snap["counters"] == {} and snap["dropped"] == 0
    assert snap["launches"]["linear.linear"] == _linear_launches()


def _linear_launches():
    from adt_str_tpu_torch.ops import linear

    return linear.linear.launches


def test_nesting_gives_parents_ids_and_self_times():
    spans.enable(True)
    with spans.span("serve.batch", batch=4, bucket=8, rows=5):
        with spans.span("decode.step", step=0):
            time.sleep(0.02)  # off the CPU
        with spans.span("decode.step", step=1):
            pass
    spans.count("kernels.built")
    spans.count("kernels.built", 2)
    snap = spans.snapshot()
    outer, first, second = snap["spans"]
    assert [r["name"] for r in snap["spans"]] == ["serve.batch", "decode.step", "decode.step"]
    assert outer["parent"] is None and first["parent"] == second["parent"] == outer["seq"]
    # a child inherits the batch, never the bucket or rows
    assert outer["ids"] == {"batch": 4, "bucket": 8, "rows": 5}
    assert first["ids"] == {"batch": 4, "step": 0} and second["ids"] == {"batch": 4, "step": 1}
    wall = {r["seq"]: r["end_ns"] - r["start_ns"] for r in snap["spans"]}
    own = spans.self_ns(snap["spans"])
    assert own[outer["seq"]] == wall[outer["seq"]] - wall[first["seq"]] - wall[second["seq"]] >= 0
    assert own[first["seq"]] == wall[first["seq"]] >= 20e6
    assert first["cpu_ns"] < wall[first["seq"]] / 2  # asleep, the thread is off the CPU
    assert {(r["thread"], r["thread_name"]) for r in snap["spans"]} == {(threading.get_native_id(),
                                                                        threading.current_thread().name)}
    assert snap["counters"] == {"kernels.built": 3}
    spans.reset()
    assert spans.snapshot()["spans"] == [] and spans.snapshot()["counters"] == {}


def test_one_requests_spans_on_two_threads_share_its_id():
    spans.enable(True)
    both = threading.Barrier(2)  # both threads alive at once: their idents differ

    def client():
        with spans.span("client.submit", request=7):
            both.wait(30.0)

    def server():
        with spans.span("server.decode", request=7):
            with spans.span("server.step", step=0):
                both.wait(30.0)

    threads = [threading.Thread(target=client), threading.Thread(target=server)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    records = spans.snapshot()["spans"]
    assert len(records) == 3 and len({r["thread"] for r in records}) == 2
    assert all(r["ids"]["request"] == 7 for r in records)


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(spans, "CAPACITY", 2)
    spans.enable(True)
    for step in range(5):
        with spans.span("decode.step", step=step):
            pass
    snap = spans.snapshot()
    assert [r["ids"]["step"] for r in snap["spans"]] == [0, 1] and snap["dropped"] == 3


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e["name"] for e in sorted((e for e in events if e.get("cat") == "user_annotation"),
                                      key=lambda e: e["ts"])]


def test_a_profiler_session_holds_one_annotation_per_record(tmp_path):
    spans.enable(True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span("train.step", step=3):
            with spans.span("train.forward"):
                torch.ones(4).add_(1)
            with spans.span("train.optimizer"):
                torch.ones(4).mul_(2)
    records = spans.snapshot()["spans"]
    assert _annotations(prof, tmp_path) == [spans.label(r["name"], r["ids"]) for r in records] == \
        ["train.step[step=3]", "train.forward[step=3]", "train.optimizer[step=3]"]


def test_spans_off_still_annotate_a_recording_profiler(tmp_path):
    """A profiler session (the trainer's `profile_steps`) carries the spans
    without `enable`; nothing is kept in memory."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span("train.step", step=0):
            with spans.span("train.render"):
                torch.ones(4).add_(1)
    assert _annotations(prof, tmp_path) == ["train.step[step=0]", "train.render[step=0]"]
    assert spans.snapshot()["spans"] == []


@pytest.mark.parametrize("beam", [False, True])
def test_decode_with_spans_on_gives_the_same_tokens_and_one_span_a_phase(beam):
    model, max_length = _model(seed=1, eos_bias=-1e4), 9
    wave = torch.from_numpy(_waves(2, seed=3))

    def decode():
        if beam:
            return tdecode.beam_search_decode(model, wave, max_length=max_length, beam_size=2, end_token=EOS)
        return tdecode.greedy_decode(model, wave, max_length=max_length, end_token=EOS)

    off = decode()
    assert spans.snapshot()["spans"] == []
    spans.enable(True)
    on = decode()
    assert torch.equal(off, on)
    records = spans.snapshot()["spans"]
    steps, tests = _named(records, "decode.step"), _named(records, "decode.exit_test")
    assert len(_named(records, "decode.encode")) == 1
    assert [r["ids"]["step"] for r in steps] == list(range(max_length - 1))
    assert len(tests) == max_length - 1  # every row decodes to the last step: no test after it
    assert all(r["parent"] is None for r in records)


def test_an_early_exit_takes_one_more_test_than_steps():
    model = _model(seed=1, eos_bias=1e4)  # every row ends at its first token
    spans.enable(True)
    tokens = tdecode.greedy_decode(model, torch.from_numpy(_waves(2)), max_length=9, end_token=EOS)
    assert (tokens[:, 1:] == EOS).all()
    records = spans.snapshot()["spans"]
    assert len(_named(records, "decode.step")) == 1 and len(_named(records, "decode.exit_test")) == 2


def test_the_synth_train_step_records_render_forward_backward_and_optimizer_under_its_step():
    mc = ModelConfig(sample_rate=SR, win_length=256, time_res=0.01, input_sec=CHUNK_SEC, enc_layers=1, dec_layers=1,
                     nhead=1, d_query=32, tgt_vocab_size=40, n_mels=16, compute_dtype="float32", max_positions=64,
                     dropout=0.1)
    sc = SynthConfig(**SYNTH)
    statics = trender.SynthStatics.from_bank(make_test_bank(np.random.default_rng(0), [35, 38, 42, 48],
                                                            sample_rate=SR, max_len=L), device="cpu")
    model = ADTModel(mc, seed=0, device="cpu")
    opt, _ = make_optimizer(TrainingConfig(learning_rate=1e-3, warmup_ratio=0.0), total_steps=4, model=model)
    step = tstep.make_synth_train_step(mc, sc, statics, opt, device="cpu")
    state = tstep.init_train_state(model, opt)
    rng = np.random.default_rng(0)
    B, N = 2, sc.max_notes
    on = rng.uniform(0, CHUNK_SEC, (B, N)).astype(np.float32)
    notes = np.stack([on, on + 0.05, rng.choice([35, 38, 42, 48], (B, N)), rng.integers(1, 128, (B, N))], -1)
    tokens = np.full((B, 16), 1, np.int64)
    tokens[:, 0], tokens[:, 1:8], tokens[:, 8] = 2, rng.integers(4, 40, (B, 7)), EOS
    batch = {"notes": torch.from_numpy(notes.astype(np.float32)), "note_mask": torch.ones(B, N, dtype=torch.bool),
             "tokens": torch.from_numpy(tokens), "token_lengths": torch.full((B,), 9)}
    gen = torch.Generator().manual_seed(0)
    state, _ = step(state, batch, trender.draw_render(statics, B, sc, gen), draw_site_keys(mc, gen))
    spans.enable(True)
    state, metrics = step(state, batch, trender.draw_render(statics, B, sc, gen), draw_site_keys(mc, gen))
    assert torch.isfinite(metrics["loss"])
    records = spans.snapshot()["spans"]
    assert [r["name"] for r in records] == ["train.step", "train.render", "train.forward", "train.backward",
                                            "train.optimizer"]
    top = records[0]
    assert top["parent"] is None and all(r["parent"] == top["seq"] for r in records[1:])
    assert all(r["ids"] == {"step": 1} for r in records)


def test_engine_stats_report_the_queue_wait_and_its_batches_record_their_phases():
    """The first request is taken at once and its decode held; two more
    wait in the queue for at least `HOLD` seconds each."""
    HOLD = 0.2
    cfg = FrameworkConfig.from_dict(TINY)
    spans.enable(True)
    with ServingEngine(_model(), cfg, device="cpu", buckets=(1, 2, 4), max_wait_ms=0.0) as eng:
        entered, release = threading.Event(), threading.Event()
        decode = eng._decode_device

        def held(waves):
            entered.set()
            release.wait(30.0)
            return decode(waves)

        eng._decode_device = held
        waves = _waves(3)
        first = eng.submit_chunk(waves[0])
        assert entered.wait(30.0)
        rest = [eng.submit_chunk(w) for w in waves[1:]]
        time.sleep(HOLD)
        release.set()
        for fut in [first, *rest]:
            assert fut.result(timeout=120).shape == (cfg.inference.max_length,)
        stats = eng.stats()
    assert stats["n_requests"] == 3 and stats["queue_wait_seconds"] >= 2 * HOLD
    records = spans.snapshot()["spans"]
    batches = _named(records, "serve.batch")
    assert [r["ids"] for r in batches] == [{"batch": 0, "bucket": 1, "rows": 1}, {"batch": 1, "bucket": 2, "rows": 2}]
    assert len(_named(records, "serve.collect")) == 2
    for b in batches:
        children = [r["name"] for r in records if r["parent"] == b["seq"]]
        assert children[0] == "decode.encode" and children[-2:] == ["serve.tokens_out", "serve.answer"]
        assert set(children[1:-2]) == {"decode.step", "decode.exit_test"}
        assert all(r["ids"]["batch"] == b["ids"]["batch"] for r in records if r["parent"] == b["seq"])


def test_greedy_program_exports_the_same_graph_with_spans_on():
    model = _model(seed=2)
    off = texport.build_exported(model, max_length=6, batch_size=2)
    spans.enable(True)
    on = texport.build_exported(model, max_length=6, batch_size=2)
    assert on.graph_module.code == off.graph_module.code
    assert spans.snapshot()["spans"] == []
    wave = torch.from_numpy(_waves(2, seed=4))
    assert torch.equal(on.module()(wave), off.module()(wave))


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A csrc directory of one source, an `nvcc` that writes its output
    file, and a loader that loads nothing."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// kernel a\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = "-o" ] && : > "$2"; shift; done\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("loaded", path))


def test_a_build_counts_once_and_a_cached_load_counts_as_not_built(fake_nvcc, monkeypatch):
    spans.enable(True)
    lib = _build.load("a")
    assert _build.load("a") is lib  # loaded once a process
    monkeypatch.setattr(_build, "_libs", {})  # a new process: the library is on disk
    _build.load("a")
    snap = spans.snapshot()
    assert [r["ids"] for r in _named(snap["spans"], "kernels.load")] == [{"library": "a", "built": True},
                                                                           {"library": "a", "built": False}]
    assert snap["counters"] == {"kernels.built": 1}
