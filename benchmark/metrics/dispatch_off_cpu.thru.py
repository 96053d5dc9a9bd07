"""% of the dispatcher's wall time in `decode.step` for which its thread was
off the CPU (wall less the thread's CPU time): the GIL and the OS taking the
dispatcher from its launches, over the window's untraced batches."""

from benchmark.spans import off_cpu


def read(layer: dict):
    return off_cpu(layer, "decode.step")
