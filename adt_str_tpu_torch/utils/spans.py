"""Spans and counters at the port's layer boundaries.

`with span("decode.step", step=s):` marks one phase of the host's work.
Spans are off by default; off, a span costs two flag tests and returns a
shared no-op. A caller turns them on with `enable(True)`: each span then
keeps a record in memory (its name, its start and end on
`time.perf_counter_ns`, the thread (its native id, as a profiler's trace
names it, and its name) and the thread's CPU time over the span,
the enclosing span on the same thread, and its ids), read out with
`snapshot()` once the run ends and cleared with `reset()`. Nothing is
written during the run; the records go into a buffer of `CAPACITY`, past
which new records are counted as dropped.

Ids are keyword arguments (`batch`, `request`, `step`, or what a boundary
names). A span inherits the `INHERITED` ids of its enclosing span on the
same thread, so a decode step carries its batch; spans of one request on
two threads share the request id that each is given.

While a `torch.profiler` session records, each span also opens
`torch.profiler.record_function(label(name, ids))`, on or off, so the
span appears as a `user_annotation` event in the session's trace, on the
same clock as the kernels it launches; with spans on, the in-memory record
carries the same name and ids. A session records these events only on the
thread that started it, unless it is made with
`experimental_config=torch._C._profiler._ExperimentalConfig(
profile_all_threads=True)`: the serving engine's spans run on its
dispatcher thread. While `torch.compile` or `torch.export`
traces, a span is a no-op, so no graph holds one.

`count(name, n)` adds to a counter while spans are on. `snapshot()` also
reports the kernel wrappers' `launches` counters, read from the wrappers.
"""

from __future__ import annotations

import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 1 << 18
INHERITED = ("batch", "request", "step")

_on = False
_records: list[tuple] = []
_dropped = 0
_counters: dict[str, int] = {}
_lock = threading.Lock()
_seq = itertools.count()
_local = threading.local()


def enable(on: bool = True) -> None:
    """Keep a record of every span and counter from now on (or stop)."""
    global _on
    _on = bool(on)


def label(name: str, ids: dict) -> str:
    """The profiler annotation's name: `name[k=v ...]`, or `name` alone."""
    return f"{name}[{' '.join(f'{k}={v}' for k, v in ids.items())}]" if ids else name


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "ids", "keep", "seq", "parent", "annotation", "t0", "c0")

    def __init__(self, name: str, ids: dict):
        self.name, self.ids = name, ids

    def __enter__(self) -> "_Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        if parent is not None:
            inherited = {k: parent.ids[k] for k in INHERITED if k in parent.ids and k not in self.ids}
            if inherited:
                self.ids = {**inherited, **self.ids}
        self.parent = None if parent is None else parent.seq
        self.seq = next(_seq)
        self.keep = _on
        stack.append(self)
        self.annotation = None
        if _profiler._is_profiler_enabled:
            self.annotation = torch.profiler.record_function(label(self.name, self.ids))
            self.annotation.__enter__()
        self.c0 = time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        c1 = time.thread_time_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _local.stack.pop()
        if self.keep:
            thread = threading.current_thread()
            _keep((self.name, self.t0, t1, c1 - self.c0, thread.native_id, thread.name, self.seq, self.parent,
                   self.ids))
        return False


def span(name: str, **ids):
    """A context manager around one phase of the host's work; see the
    module docstring."""
    if not (_on or _profiler._is_profiler_enabled):
        return _NOOP
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return _NOOP
    return _Span(name, ids)


def _keep(record: tuple) -> None:
    global _dropped
    if len(_records) < CAPACITY:
        _records.append(record)
    else:
        with _lock:
            _dropped += 1


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` while spans are on."""
    if _on:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def launches() -> dict[str, int]:
    """Every kernel wrapper's `launches` counter, as `<module>.<wrapper>`."""
    from adt_str_tpu_torch.ops import attention_rows, cuda_attention, cuda_ffn, cuda_mel, cuda_place, layer_norm, linear

    out = {}
    for module in (attention_rows, cuda_attention, cuda_ffn, cuda_mel, cuda_place, layer_norm, linear):
        for fn in vars(module).values():
            n = getattr(fn, "launches", None)
            if callable(fn) and isinstance(n, int):
                out[f"{fn.__module__.rsplit('.', 1)[-1]}.{fn.__name__}"] = n
    return dict(sorted(out.items()))


_FIELDS = ("name", "start_ns", "end_ns", "cpu_ns", "thread", "thread_name", "seq", "parent", "ids")


def snapshot() -> dict:
    """-> {"spans": the records in order of start, each a dict of
    `_FIELDS` ("parent" the enclosing span's "seq", or None), "counters",
    "launches", "dropped"}."""
    with _lock:
        records, counters, dropped = list(_records), dict(_counters), _dropped
    spans = [dict(zip(_FIELDS, r)) for r in sorted(records, key=lambda r: (r[1], r[6]))]
    return {"spans": spans, "counters": counters, "launches": launches(), "dropped": dropped}


def reset() -> None:
    """Forget every record, counter and drop."""
    global _dropped
    with _lock:
        _records.clear()
        _counters.clear()
        _dropped = 0


def self_ns(spans: list[dict]) -> dict[int, int]:
    """Each span's own time (its wall time less its children's), by "seq"."""
    own = {s["seq"]: s["end_ns"] - s["start_ns"] for s in spans}
    for s in spans:
        if s["parent"] in own:
            own[s["parent"]] -= s["end_ns"] - s["start_ns"]
    return own
