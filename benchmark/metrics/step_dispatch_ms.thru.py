"""Host ms a greedy step in the program's `decode.step` span (the step's
launches, the token's choice and writes), over the window's untraced
batches."""

from benchmark.spans import host_ms


def read(layer: dict):
    return host_ms(layer, "decode.step")
