from benchmark.metrics import kernels_roofline as read  # noqa: F401
