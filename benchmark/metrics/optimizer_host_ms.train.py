"""Host ms a step in the program's `train.optimizer` span (AdamW's update,
its application and the gradients' norm), over the window's untraced
steps."""

from benchmark.spans import host_ms


def read(layer: dict):
    return host_ms(layer, "train.optimizer")
