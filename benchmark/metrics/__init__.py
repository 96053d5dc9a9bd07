"""Per-layer metric readers: `<metric>.py` beside this file holds
`read(layer) -> value or None` for the metric of that name, where `layer`
is what the cell's driver hands over (the traced span's summary, the
kernels' bounds, the model's FLOPs, counters). A reader that finds nothing
to read returns None, and the metric is left out of the run's line."""

from __future__ import annotations

from benchmark import roofline, tracing


def span(layer: dict):
    summary = layer.get("trace")
    return summary if summary and summary["units"] > 0 else None


def idle_share(layer: dict):
    """% of the untraced time a unit (`unit_s`: a training step, a served
    batch) in which nothing ran on the device: the traced span's busy
    seconds a unit against it, so the profiler's own cost is not counted."""
    s = span(layer)
    if s is None or not layer.get("unit_s"):
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["units"] / layer["unit_s"])


def mfu(layer: dict):
    """% of the bf16 tensor-core peak: the model's FLOPs a unit
    (`flops_unit`) over the untraced time a unit."""
    if not layer.get("unit_s"):
        return None
    return 100.0 * layer["flops_unit"] / layer["unit_s"] / roofline.PEAK_BF16


def kernels_roofline(layer: dict):
    """% of their least time that the port's kernels took: the sum of the
    kernels' bounds for the span's work (`bound_span_s`) over their device
    time in it."""
    s = span(layer)
    if s is None:
        return None
    took = sum(tracing.kernel_seconds(s, key) for key in layer["kernel_keys"].values())
    if took <= 0:
        return None
    return 100.0 * sum(layer["bound_span_s"].values()) / took


def peak_mem_gib(layer: dict):
    return layer["peak_mem_window"] / 2**30 if layer.get("peak_mem_window") else None
