"""Device ms a step in the dropout hash's int64 elementwise kernels
(`roofline.group`'s rule), over the traced span's steps."""

from benchmark import roofline
from benchmark.metrics import span


def read(layer: dict):
    s = span(layer)
    if s is None or not s["by_group_s"].get(roofline.HASH_GROUP):
        return None
    return 1e3 * s["by_group_s"][roofline.HASH_GROUP] / s["units"]
