"""Device ms a traced step of the work launched inside the program's
`train.render` span: K2, K3 and the FX chain."""

from benchmark.spans import device_ms


def read(layer: dict):
    return device_ms(layer, "train.render")
