from benchmark.metrics import mfu as read  # noqa: F401
