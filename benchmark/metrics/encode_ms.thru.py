"""Device ms in the traced batch of the work launched inside the program's
`decode.encode` span: the encoder and the cross K/V projection."""

from benchmark.spans import device_ms


def read(layer: dict):
    return device_ms(layer, "decode.encode")
