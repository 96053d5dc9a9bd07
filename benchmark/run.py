"""One run of one cell of the port's benchmark, on the machine it starts on:

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration and its traffic
mix are found by name (`BENCHMARK.json`, `benchmark/configs/<config>.json`,
`benchmark/traffic/<mix>.json`); the mix's `kind` names the driver
(`benchmark/drivers/<kind>.py`), and each per-layer metric has a reader of
its own (`benchmark/metrics/<metric>.py`). With `--trace 0` the result
carries the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics from a traced sub-window. The last line of standard output is the
result's JSON; the numbers that decide `correct` are the last lines of
standard error, each beside its limit, and the result's last key.

Exits non-zero, with no result, without a CUDA card or with fewer than the
cell asks for, and when JAX or the JAX package is loaded once the window
has closed. Build and kernel caches stay inside the checkout.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
WORK = ROOT / "build" / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "adt_str_tpu")


def _environment() -> None:
    """Caches at fixed paths inside the checkout; no library loads JAX."""
    os.environ["TRITON_CACHE_DIR"] = str(WORK / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(WORK / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(WORK / "inductor")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the
    JAX package's, compared whole (the port's name begins with the JAX
    package's)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def load_cell(name: str) -> tuple[dict, dict, dict, dict]:
    """-> (BENCHMARK.json, the cell, its configuration file, its mix)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    from benchmark import traffic

    return bench, cell, config, traffic.load(cell["traffic"])


def metric_reader(name: str):
    """`benchmark/metrics/<name>.py`'s `read(layer) -> value or None`."""
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, cell: dict, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: its end-to-end ones, or with a
    trace its per-layer ones."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}

    def reported(m: dict) -> bool:
        return name in m["workloads"] if "workloads" in m else m["moves"] in moved

    return [m for m in bench["per_layer"] if reported(m)]


def main(argv=None) -> int:
    faulthandler.enable(all_threads=True)  # a fatal signal prints every thread's stack to standard error
    _environment()
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    bench, cell, config, mix = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from benchmark.drivers import Context

    driver = importlib.import_module(f"benchmark.drivers.{mix['kind']}")
    ctx = Context(seed=args.seed, seconds=args.seconds, trace=bool(args.trace), device=torch.device("cuda:0"),
                  config=config, mix=mix, t_start=T_START, work_dir=WORK)
    out = driver.run(ctx)
    found = forbidden_modules()
    if found:
        print(f"loaded in the process that reports: {found}", file=sys.stderr)
        return 3
    line = result_line(bench, cell, out, bool(args.trace))
    for name, (value, limit) in out["checks"].items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


def result_line(bench: dict, cell: dict, out: dict, trace: bool) -> dict:
    """The contract's last line from a driver's output."""
    import torch

    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        value = out["e2e"].get(m["name"]) if not trace else metric_reader(m["name"])(out["layer"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line = {"correct": bool(out["correct"]), "attempted": int(out["attempted"]), "failed": int(out["failed"]),
            "metrics": metrics, "device": device}
    summary = out["trace"]
    if trace and summary is not None:
        device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        line["breakdown"] = summary["breakdown"]
    line["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in out["checks"].items()}
    return line


if __name__ == "__main__":
    code = main()
    # every thread the run started has ended and the result is out: leave without the
    # libraries' teardown (the profiler's and CUDA's), which runs after the run's work
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
