"""Host ms a step in the program's `decode.exit_test` span, where the host
waits for the device to say whether every row finished, over the window's
untraced batches."""

from benchmark.spans import host_ms


def read(layer: dict):
    return host_ms(layer, "decode.exit_test")
