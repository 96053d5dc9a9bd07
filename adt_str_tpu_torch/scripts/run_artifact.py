"""Run saved serving artifacts (`scripts/export_serving.py`) as a serving
host would: a process that imports `torch` and `adt_str_tpu_torch.ops` (the
kernels' custom ops) and nothing else of the port.

`PYTHONPATH=<repo> python adt_str_tpu_torch/scripts/run_artifact.py JOB.json`
(run by path, so no other package of the port is imported). JOB holds
`device`, `eos` (the end token), `out`, `artifacts`: {label: {"path": the
saved program, "runs": {name: a `torch.save`d (B, samples) float32 wave},
"timed": the names of the runs to time}}, and optionally `wait_s` and
`timed_after`. Each artifact is loaded as soon as its file exists (waiting
up to `wait_s`: the job may start while another process still writes
them), and each run's first call gives its tokens and the launches of every
registered kernel in it. Then, once `timed_after` exists, each timed run
takes `loop_figures` of two more calls. It writes the tokens to `out`
(`torch.save`, {label: {name: tokens}}) and prints one JSON line: the
port's modules it imported and, by artifact, the load seconds and each
run's launches and figures.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

from adt_str_tpu_torch.ops import _build, op_wrappers

PROFILE_TRIES = 3  # a profiler session on the card now and then records no device event: it is taken again
TOP_KERNELS = 10  # the device kernels (by name) whose time `loop_figures` reports
KERNEL_NAME_CHARS = 80
WAIT_POLL_S = 0.2


def decode_steps(tokens: torch.Tensor, eos: int) -> int:
    """The steps a greedy loop ran for these tokens: until the last row's
    first EOS, or the length budget."""
    n = tokens.shape[1]
    at = torch.arange(1, n, device=tokens.device)
    first = torch.where(tokens[:, 1:] == eos, at, n).min(dim=1).values.max().item()
    return int(min(first, n - 1))


def loop_figures(call, wave: torch.Tensor, eos: int) -> tuple[dict, torch.Tensor]:
    """One transcription call `call(wave)` (encode and the greedy loop) on
    the card: its host wall time (CUDA synchronised) and, from a second
    call under torch.profiler, the device's busy time (kernels, copies and
    sets from the trace), each whole and a decode step, and the
    `TOP_KERNELS` device kernels that took most of it, by name; -> (those
    figures, the first call's tokens)."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    tokens = call(wave)
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3
    steps = decode_steps(tokens, eos)
    trace = _build.BUILD_DIR.parent / f"artifact_trace_{wave.shape[0]}.json"
    busy_ms, by_kernel = None, {}
    for _ in range(PROFILE_TRIES):  # the device's activity alone: a whole loop's host events make a slow trace
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            call(wave)
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text()).get("traceEvents", [])
        kernels = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        if kernels:
            busy_ms = sum(float(e.get("dur", 0)) for e in kernels) / 1e3
            for e in kernels:
                name = e.get("name", "?")[:KERNEL_NAME_CHARS]
                by_kernel[name] = by_kernel.get(name, 0.0) + float(e.get("dur", 0)) / 1e3
            break
    trace.unlink(missing_ok=True)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]
    return {"rows": wave.shape[0], "steps": steps, "wall_ms": wall_ms, "wall_ms_per_step": wall_ms / max(steps, 1),
            "device_ms": busy_ms, "device_ms_per_step": None if busy_ms is None else busy_ms / max(steps, 1),
            "device_ms_by_kernel": dict(top)}, tokens


def wait_for(path: str, timeout: float) -> None:
    """Until `path` exists (a file another process writes whole, then renames into place)."""
    deadline = time.monotonic() + timeout
    while not Path(path).exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear within {timeout} s")
        time.sleep(WAIT_POLL_S)


def main(job_path: str) -> None:
    job = json.loads(Path(job_path).read_text())
    device, timeout = torch.device(job["device"]), job.get("wait_s", 0)
    wrappers = op_wrappers()
    summary, tokens, programs = {}, {}, {}
    with torch.no_grad():
        for label, art in job["artifacts"].items():  # each as soon as it is written
            wait_for(art["path"], timeout)
            t0 = time.monotonic()
            programs[label] = program = torch.export.load(art["path"]).module()
            summary[label], tokens[label] = {"load_s": time.monotonic() - t0, "runs": {}}, {}
            for name, wave_path in art["runs"].items():
                wave = torch.load(wave_path, weights_only=True).to(device)
                before = {k: f.launches for k, f in wrappers.items()}
                t0 = time.monotonic()
                tokens[label][name] = program(wave).cpu()
                summary[label]["runs"][name] = {"first_call_s": time.monotonic() - t0,
                                                "launches": {k: f.launches - before[k] for k, f in wrappers.items()}}
        if job.get("timed_after"):  # no other work on the host while the loops are timed
            wait_for(job["timed_after"], timeout)
        for label, art in job["artifacts"].items():
            for name in art.get("timed", ()):
                wave = torch.load(art["runs"][name], weights_only=True).to(device)
                summary[label]["runs"][name].update(loop_figures(programs[label], wave, job["eos"])[0])
    torch.save(tokens, job["out"])
    port = sorted(m for m in sys.modules if m.startswith("adt_str_tpu_torch"))
    print(json.dumps({"port_modules": port, "artifacts": summary}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
