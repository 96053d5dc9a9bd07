"""The traced sub-window: a torch.profiler session over a few steady steps
of the timed path, read back from its chrome trace.

The span read is cut where the driver says, so it holds whole units of
work (training steps; a whole served batch). Within it: the seconds in
which any kernel, copy or set ran on the device (`busy_s`), the span's
length (`window_s`), device time by kernel name and by group
(`roofline.group`), the device ops that took most time, and the longest
idle gaps, each named by the innermost host op that was running at its
middle. The profiler's own host cost slows the span, so a share of time
is taken against the same run's untraced time a unit (`metrics`).
"""

from __future__ import annotations

import bisect
import json
import os
import sys
from pathlib import Path

import torch

from benchmark import roofline

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
SETTLE_S = 1.5  # the device waits this long after a session starts: its first events can be lost


def warm_up() -> None:
    """One short session at set-up, so that the tracer is loaded before the
    session that counts."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class Profile:
    """`with Profile(path) as p:` ... then `p.events()` reads the trace."""

    def __init__(self, path: Path):
        self.path = path
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                       torch.profiler.ProfilerActivity.CUDA])

    def __enter__(self) -> "Profile":
        self.prof.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))

    def events(self) -> list[dict]:
        """The trace's events; the file is removed once read, and its device
        events are kept, in short, as `<path>.device.json` for a look."""
        try:
            events = json.loads(self.path.read_text()).get("traceEvents", [])
        finally:
            os.remove(self.path)
        brief = [[e.get("cat"), e.get("name", "")[:60], e.get("ts"), e.get("dur"), e.get("args", {}).get("bytes")]
                 for e in device_events(events)]
        self.path.with_suffix(".device.json").write_text(json.dumps(brief))
        return events


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def device_events(events: list[dict]) -> list[dict]:
    return [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]


def between(device: list[dict], marker) -> dict | None:
    """The span from the first to the last start of a device event that
    `marker(event)` picks, in whole units between markers -> {"lo", "hi",
    "units"}, or None with fewer than two."""
    marks = sorted(float(e["ts"]) for e in device if marker(e))
    if len(marks) < 2:
        return None
    return {"lo": marks[0], "hi": marks[-1], "units": len(marks) - 1}


def summarize(events: list[dict], span) -> dict | None:
    """`span(device events) -> {"lo", "hi", "units", ...} or None` cuts the
    trace into whole units of work -> {"span" (that dict), "units",
    "window_s", "busy_s", "by_name_s", "by_group_s", "breakdown"}; None when
    the trace holds no such span."""
    device = device_events(events)
    cut = span(device)
    if cut is None:
        print(f"trace: no span among {len(device)} device events", file=sys.stderr)
        return None
    lo, hi, units = cut["lo"], cut["hi"], cut["units"]
    inside = [e for e in device if lo <= float(e["ts"]) < hi]
    by_name: dict[str, float] = {}
    for e in inside:
        name = e.get("name", "")
        by_name[name] = by_name.get(name, 0.0) + min(float(e.get("dur", 0)), hi - float(e["ts"])) / 1e6
    by_group: dict[str, float] = {}
    for name, s in by_name.items():
        by_group[roofline.group(name)] = by_group.get(roofline.group(name), 0.0) + s
    busy = _union([(float(e["ts"]), min(float(e["ts"]) + float(e.get("dur", 0)), hi)) for e in inside])
    gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip([(lo, lo)] + busy, busy + [(hi, hi)]) if b[0] > a[1]]
    gaps.sort(reverse=True)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("name", ""))
                  for e in events if e.get("cat") in ("cpu_op", "cuda_runtime", "user_annotation")
                  and e.get("ph") == "X")
    starts = [h[0] for h in host]

    def host_at(t: float) -> str:
        best = None
        for s, e, name in host[max(0, bisect.bisect_right(starts, t) - 2000) : bisect.bisect_right(starts, t)]:
            if s <= t <= e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        return best[2] if best else "no traced host op (Python between ops)"

    return {"span": cut, "units": units, "window_s": (hi - lo) / 1e6, "busy_s": sum(e - s for s, e in busy) / 1e6,
            "by_name_s": by_name, "by_group_s": by_group,
            "breakdown": {"device_ops": sorted(([n[:160], s] for n, s in by_name.items()), key=lambda x: -x[1])[:TOP],
                          "idle_gaps": [[host_at((s + e) / 2)[:160], g / 1e6] for g, s, e in gaps[:TOP]]}}


def kernel_seconds(summary: dict, key: str) -> float:
    """Device seconds in the span of the kernels whose name holds `key`."""
    return sum(s for n, s in summary["by_name_s"].items() if key in n)
