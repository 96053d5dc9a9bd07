"""The program's spans in a trace, on hand-made events: device time given to
the innermost span that launched it, by correlation and else by stream
order; idle gaps by the span open at their middle; and the readers of the
span metrics, which find nothing where a driver hands no spans over."""

from __future__ import annotations

import pytest

from benchmark import spans
from benchmark.run import metric_reader

MAIN, OTHER = 11, 22  # host threads
METRICS = ("encode_ms.thru", "step_dispatch_ms.thru", "exit_wait_ms.thru", "dispatch_off_cpu.thru",
           "render_ms.train", "optimizer_host_ms.train")


def _span(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "tid": tid, "ts": ts, "dur": dur}


def _launch(corr, ts, tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": tid, "ts": ts, "dur": 2.0,
            "args": {"correlation": corr}}


def _kernel(ts, dur, corr=None, stream=7):
    args = {"stream": stream} if corr is None else {"stream": stream, "correlation": corr}
    return {"ph": "X", "cat": "kernel", "name": "k", "tid": stream, "ts": ts, "dur": dur, "args": args}


def _batch():
    """A batch [0, 100) on the main thread: the encode [0, 30), a step
    [40, 60), its exit test [60, 65); a span of another thread over it all;
    launches in each, one in the batch's own time and one after it."""
    return [_span("serve.batch[batch=0 bucket=64 rows=64]", 0.0, 100.0), _span("decode.encode[batch=0]", 0.0, 30.0),
            _span("decode.step[batch=0 step=0]", 40.0, 20.0), _span("decode.exit_test[batch=0]", 60.0, 5.0),
            _span("train.step[step=9]", 0.0, 300.0, tid=OTHER), _span("ProfilerStep#3", 0.0, 300.0),
            _launch(1, 10.0), _launch(2, 45.0), _launch(3, 70.0), _launch(4, 200.0),
            _kernel(20.0, 5.0, 1), _kernel(50.0, 10.0, 2), _kernel(61.0, 2.0), _kernel(75.0, 5.0, 3),
            _kernel(210.0, 4.0, 4), _kernel(5.0, 1.0, stream=8)]


def test_device_time_goes_to_the_innermost_span_of_its_launch():
    got = spans.attribute(_batch(), 0.0, 1000.0)
    # the launches' own thread decides: the other thread's open span takes none of them
    assert got["by_span_s"] == {"decode.encode": pytest.approx(5e-6), "decode.step": pytest.approx(12e-6),
                                "serve.batch": pytest.approx(5e-6), spans.OUTSIDE: pytest.approx(4e-6)}
    # the kernel without a partner at 61 follows the step's on stream 7; the one on stream 8 has none before it
    assert got["correlated_s"] == pytest.approx(24e-6) and got["stream_order_s"] == pytest.approx(2e-6)
    assert got["unmatched_s"] == pytest.approx(1e-6) and got["device_s"] == pytest.approx(27e-6)


def test_attribution_keeps_the_window_and_clips_at_its_end():
    got = spans.attribute(_batch(), 40.0, 55.0)
    # in [40, 55): the step's kernel at 50, cut to 5 us
    assert got["by_span_s"] == {"decode.step": pytest.approx(5e-6)} and got["device_s"] == pytest.approx(5e-6)


def test_a_partnerless_kernel_follows_a_correlated_one_from_before_the_window():
    events = [_span("train.render[step=1]", 0.0, 10.0), _launch(1, 2.0), _kernel(3.0, 4.0, 1), _kernel(8.0, 2.0)]
    got = spans.attribute(events, 6.0, 100.0)
    assert got["by_span_s"] == {"train.render": pytest.approx(2e-6)} and got["stream_order_s"] == pytest.approx(2e-6)


def test_idle_gaps_go_to_the_span_open_at_their_middle():
    events = [_span("decode.step[step=0]", 0.0, 40.0), _span("decode.exit_test", 40.0, 10.0),
              _launch(1, 0.0), _launch(2, 20.0), _launch(3, 45.0),
              _kernel(0.0, 10.0, 1), _kernel(30.0, 5.0, 2), _kernel(60.0, 10.0, 3)]
    got = spans.idle_by_span(events, 0.0, 100.0)
    # gaps: (10, 30) mid 20 in the step; (35, 60) mid 47.5 in the test; (70, 100) mid 85 in none
    assert got["by_span_s"] == {spans.OUTSIDE: pytest.approx(30e-6), "decode.exit_test": pytest.approx(25e-6),
                                "decode.step": pytest.approx(20e-6)}
    assert got["idle_s"] == pytest.approx(75e-6)
    lines = spans.table(got, spans.attribute(events, 0.0, 100.0), units=1).splitlines()
    assert lines[1] == f"  {spans.OUTSIDE}: 0.030 (40.0%)"
    assert lines[-1].startswith("device time attributed by correlation 100.00%, by stream order 0.00%")


def test_only_the_programs_annotations_are_spans():
    names = [s[3] for s in spans.program_spans(_batch())]
    assert names == ["serve.batch", "decode.encode", "decode.step", "decode.exit_test", "train.step"]


def _record(name, start, wall, cpu, **ids):
    return {"name": name, "start_ns": start, "end_ns": start + wall, "cpu_ns": cpu, "ids": ids}


def test_the_readers_take_device_time_a_unit_and_host_time_over_the_kept_stretches():
    records = [_record("decode.step", 100, 4_000_000, 3_000_000, step=0),
               _record("decode.step", 200, 6_000_000, 3_000_000, step=1),
               _record("decode.step", 5_000, 50_000_000, 1_000_000, step=0),  # the traced batch: left out
               _record("decode.exit_test", 300, 500_000, 100_000),
               _record("train.optimizer", 400, 20_000_000, 19_000_000)]
    device = {"by_span_s": {"decode.encode": 0.012, "train.render": 0.030}}
    layer = {"program": {"device": device, "units": 2, "records": records, "keep": [(0, 1_000)]}}
    read = {name: metric_reader(name)(layer) for name in METRICS}
    assert read == {"encode_ms.thru": pytest.approx(6.0), "step_dispatch_ms.thru": pytest.approx(5.0),
                    "exit_wait_ms.thru": pytest.approx(0.5), "dispatch_off_cpu.thru": pytest.approx(40.0),
                    "render_ms.train": pytest.approx(15.0), "optimizer_host_ms.train": pytest.approx(20.0)}


@pytest.mark.parametrize("name", METRICS)
def test_a_reader_finds_nothing_where_no_spans_were_handed_over(name):
    assert metric_reader(name)({"trace": None, "unit_s": 1.0}) is None
    empty = {"program": {"device": {"by_span_s": {}}, "units": 1, "records": [], "keep": []}}
    assert metric_reader(name)(empty) is None
