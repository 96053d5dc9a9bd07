"""Host ms a decode step: the engine's `decode_seconds` (host time around
each batch's decode, which ends in a copy of its tokens to the host, so it
waits for the device; the encode included) over the window's batches
times their steps."""


def read(layer: dict):
    return 1e3 * layer["decode_step_s"] if layer.get("decode_step_s") else None
