"""The traced span's arithmetic on hand-made device events: busy and idle
time, whole training steps between K2 launches, and a whole served batch
from its encode to the copy of its tokens; and the shares of time, taken
against the untraced time a unit; and the hold around a traced batch,
which stops the dispatcher and never a client."""

from __future__ import annotations

import threading

import numpy as np
import pytest

from benchmark import roofline, tracing, traffic
from benchmark.drivers import serve_backlog
from benchmark.metrics import idle_share, mfu


def _kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def _copy(n, ts, dur=1.0):
    return {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)", "ts": ts, "dur": dur,
            "args": {"bytes": n}}


def test_busy_idle_and_units_between_markers():
    events = [_kernel("gather_blend_kernel", 0.0, 10.0), _kernel("other", 20.0, 30.0),
              _kernel("gather_blend_kernel", 100.0, 10.0), _kernel("other", 105.0, 10.0),
              _kernel("gather_blend_kernel", 200.0, 5.0), _kernel("after", 210.0, 5.0),
              {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 50.0, "dur": 50.0}]
    s = tracing.summarize(events, lambda d: tracing.between(d, lambda e: "gather_blend" in e["name"]))
    assert s["units"] == 2
    assert s["window_s"] == pytest.approx(200e-6)
    # busy: [0, 10], [20, 50], [100, 115] -> 55 us; gaps (115, 200), then (50, 100) with aten::mul under it
    assert s["busy_s"] == pytest.approx(55e-6)
    assert s["breakdown"]["idle_gaps"][:2] == [["no traced host op (Python between ops)", pytest.approx(85e-6)],
                                               ["aten::mul", pytest.approx(50e-6)]]
    assert "after" not in s["by_name_s"]


def test_a_whole_batch_spans_its_encode_to_the_copy_of_its_tokens():
    token_bytes = 64
    # the end of a batch (a test, its tokens' copy), then the next: K1, three tests, its tokens' copy, the next K1
    events = [_copy(1, 10.0), _copy(token_bytes, 20.0), _kernel("log_mel_kernel<0>", 45.0, 2.0),
              _copy(1, 50.0), _copy(1, 60.0), _copy(1, 70.0), _kernel("linear_bf16_kernel", 75.0, 1.0),
              _copy(token_bytes, 80.0, 2.0), _kernel("log_mel_kernel<0>", 90.0, 2.0)]
    device = tracing.device_events(events)
    assert serve_backlog.whole_batch(device, token_bytes, 3) == {"lo": 45.0, "hi": 82.0, "units": 1}
    # a test lost, the tokens' copy lost, or the encode lost: not a whole batch
    assert serve_backlog.whole_batch(device, token_bytes, 4) is None
    assert serve_backlog.whole_batch(device[:7], token_bytes, 3) is None
    assert serve_backlog.whole_batch(device[3:], token_bytes, 3) is None


def test_the_untraced_period_leaves_out_the_traced_batches():
    groups = [(10.0, 4), (13.0, 4), (16.0, 4), (30.0, 4), (40.0, 4), (43.5, 4), (47.0, 4)]
    # held at the end of the batch done at 16 s, on again at 38 s: pairs 10-13-16 and 40-43.5-47
    assert serve_backlog.untraced_period(groups, held=16.01, resumed=38.0) == pytest.approx(3.25)
    assert serve_backlog.untraced_period(groups[:3], None, None) == pytest.approx(3.0)
    assert serve_backlog.untraced_period(groups[:1], None, None) is None


def test_idle_and_mfu_take_the_untraced_time_a_unit():
    layer = {"trace": {"units": 2, "busy_s": 0.6, "window_s": 1.5}, "unit_s": 0.4,
             "flops_unit": 0.04 * roofline.PEAK_BF16}
    assert idle_share(layer) == pytest.approx(25.0)  # 0.3 s busy a unit of 0.4 s, not 1 - 0.6 / 1.5
    assert mfu(layer) == pytest.approx(10.0)
    assert idle_share({**layer, "unit_s": None}) is None and mfu({**layer, "unit_s": None}) is None
    assert idle_share({**layer, "trace": None}) is None


def test_a_hold_stops_the_dispatcher_and_never_a_client():
    log = serve_backlog.Backlog(None, traffic.load("backlog_greedy"), 7, 24000, 10, 2, np.zeros((1, 10), np.float32))

    def complete(n):
        for cid in range(n):
            log._done(cid, None)

    # a client that runs a done future's callback itself ends a batch's count: it goes on, nothing is held
    client = threading.Thread(target=complete, args=(2,), name="bench-client-0", daemon=True)
    log.threads.append(client)
    with log.lock:
        log.hold_next_end = True
    client.start()
    client.join(5.0)
    held_a_client = client.is_alive() or log.holding
    log.release()
    assert not held_a_client
    # the dispatcher's next batch end holds it until released
    dispatcher = threading.Thread(target=complete, args=(2,), daemon=True)
    dispatcher.start()
    assert log.hold(5.0) and dispatcher.is_alive()
    log.release()
    dispatcher.join(5.0)
    assert not dispatcher.is_alive() and log.completed == 4
