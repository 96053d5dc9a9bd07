"""The program's own spans in a traced sub-window, and the per-layer
metrics that read them.

The port marks its layer boundaries with spans (`adt_str_tpu_torch/utils/
spans.py`): while a profiler session records, each is a `user_annotation`
event named `<name>[<ids>]` on the thread that ran it, on the trace's clock;
with spans on, each is also an in-memory record on `time.perf_counter_ns`
(`spans.snapshot()["spans"]`).

- `attribute` gives each device event of the traced span to the innermost
  program span that encloses the runtime call launching it, matched by the
  trace's `correlation` id. A device event with no runtime-side partner (a
  kernel launched through a library with its own static CUDA runtime) takes
  the span of the nearest earlier correlated device event on the same
  stream, since a stream runs its work in launch order.
- `idle_by_span` sums the traced span's idle gaps by the innermost program
  span open at each gap's middle, on any thread; a gap in none is "outside
  the program" (the benchmark's own feed and draws, the profiler).
- The readers take what a driver hands over under `layer["program"]`:
  {"device": `attribute`'s result, "units": the traced units, "records":
  the snapshot's spans, "keep": the [lo, hi) intervals in perf_counter ns
  over which the host's records count (the window's untraced stretches)}.
  Without it they return None.
"""

from __future__ import annotations

import re

from benchmark import tracing

PROGRAM = re.compile(r"^(serve|decode|train|kernels)\.[a-z_]+(\[[^\]]*\])?$")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "outside the program"


def base(name: str) -> str:
    """A span's name without its ids."""
    return name.split("[", 1)[0]


def program_spans(events: list[dict]) -> list[tuple[float, float, object, str]]:
    """The trace's program spans -> [(start us, end us, thread, base name)]."""
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("tid"), base(e["name"]))
            for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"
            and PROGRAM.match(e.get("name", ""))]


def innermost(spans: list[tuple], queries: list[tuple[float, object]]) -> list[str | None]:
    """For each query (time us, thread or None), the base name of the
    innermost span open then on that thread (None: on any thread, the one
    that opened last), or None. Open and close times count as inside."""
    points = [(s, 0, i) for i, (s, _, _, _) in enumerate(spans)] + \
        [(e, 2, i) for i, (_, e, _, _) in enumerate(spans)] + [(t, 1, q) for q, (t, _) in enumerate(queries)]
    points.sort(key=lambda p: (p[0], p[1]))
    stacks: dict[object, list[int]] = {}
    out: list[str | None] = [None] * len(queries)
    for _, kind, i in points:
        if kind == 0:
            stacks.setdefault(spans[i][2], []).append(i)
        elif kind == 2:
            stacks[spans[i][2]].remove(i)
        else:
            tid = queries[i][1]
            tops = [st[-1] for st in ([stacks.get(tid, [])] if tid is not None else stacks.values()) if st]
            if tops:
                out[i] = spans[max(tops, key=lambda j: spans[j][0])][3]
    return out


def attribute(events: list[dict], lo: float, hi: float) -> dict:
    """Device seconds of the events starting in [lo, hi) (us, clipped at hi)
    by the innermost program span that launched them -> {"by_span_s" (base
    name, or OUTSIDE), "correlated_s", "stream_order_s", "unmatched_s"
    (no partner and no earlier correlated event on the stream), "device_s"}."""
    spans = program_spans(events)
    launch = {e["args"]["correlation"]: (float(e["ts"]), e.get("tid")) for e in events
              if e.get("cat") in RUNTIME_CATS and "correlation" in e.get("args", {})}
    device = sorted(tracing.device_events(events), key=lambda e: float(e["ts"]))
    partnered = [e for e in device if e.get("args", {}).get("correlation") in launch]
    names = innermost(spans, [launch[e["args"]["correlation"]] for e in partnered])
    owner = {id(e): name or OUTSIDE for e, name in zip(partnered, names)}
    out = {"by_span_s": {}, "correlated_s": 0.0, "stream_order_s": 0.0, "unmatched_s": 0.0, "device_s": 0.0}
    last_on_stream: dict[object, str] = {}
    for e in device:
        stream = e.get("args", {}).get("stream", e.get("tid"))
        ts = float(e["ts"])
        name, how = owner.get(id(e)), "correlated_s"
        if name is None:
            name, how = last_on_stream.get(stream), "stream_order_s"
        else:
            last_on_stream[stream] = name
        if not lo <= ts < hi:
            continue
        s = min(float(e.get("dur", 0)), hi - ts) / 1e6
        out["device_s"] += s
        if name is None:
            out["unmatched_s"] += s
            continue
        out[how] += s
        out["by_span_s"][name] = out["by_span_s"].get(name, 0.0) + s
    return out


def idle_by_span(events: list[dict], lo: float, hi: float) -> dict:
    """The idle gaps of [lo, hi) (us) summed by the innermost program span
    open at each gap's middle -> {"idle_s", "by_span_s" (base name, or
    OUTSIDE)}."""
    busy = tracing._union([(float(e["ts"]), min(float(e["ts"]) + float(e.get("dur", 0)), hi))
                           for e in tracing.device_events(events) if lo <= float(e["ts"]) < hi])
    gaps = [(a[1], b[0]) for a, b in zip([(lo, lo)] + busy, busy + [(hi, hi)]) if b[0] > a[1]]
    names = innermost(program_spans(events), [((s + e) / 2, None) for s, e in gaps])
    by: dict[str, float] = {}
    for (s, e), name in zip(gaps, names):
        by[name or OUTSIDE] = by.get(name or OUTSIDE, 0.0) + (e - s) / 1e6
    return {"idle_s": sum(by.values()), "by_span_s": dict(sorted(by.items(), key=lambda kv: -kv[1]))}


def table(idle: dict, device: dict, units: int) -> str:
    """The lines a traced run prints: idle ms a unit by program span, and
    how the device time was attributed."""
    lines = [f"idle by program span, ms a unit of {units}:"]
    lines += [f"  {name}: {1e3 * s / units:.3f} ({100 * s / idle['idle_s']:.1f}%)"
              for name, s in idle["by_span_s"].items()]
    total = device["device_s"] or 1.0
    lines.append(f"device time attributed by correlation {100 * device['correlated_s'] / total:.2f}%, "
                 f"by stream order {100 * device['stream_order_s'] / total:.2f}%, "
                 f"unmatched {100 * device['unmatched_s'] / total:.2f}%")
    return "\n".join(lines)


def device_ms(layer: dict, name: str):
    """Device ms a traced unit of the work launched inside span `name`."""
    p = layer.get("program") or {}
    took = (p.get("device") or {}).get("by_span_s", {}).get(name)
    return 1e3 * took / p["units"] if took and p.get("units") else None


def _kept(layer: dict, name: str) -> list[dict]:
    p = layer.get("program")
    if not p:
        return []
    return [r for r in p["records"] if r["name"] == name and any(lo <= r["start_ns"] < hi for lo, hi in p["keep"])]


def host_ms(layer: dict, name: str):
    """Mean host ms of span `name` over the kept records."""
    kept = _kept(layer, name)
    return sum(r["end_ns"] - r["start_ns"] for r in kept) / len(kept) / 1e6 if kept else None


def off_cpu(layer: dict, name: str):
    """% of the kept records' wall time in span `name` for which their
    thread was off the CPU."""
    kept = _kept(layer, name)
    wall = sum(r["end_ns"] - r["start_ns"] for r in kept)
    return 100.0 * (1.0 - sum(r["cpu_ns"] for r in kept) / wall) if wall > 0 else None
