from benchmark.metrics import idle_share as read  # noqa: F401
