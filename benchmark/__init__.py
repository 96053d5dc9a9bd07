"""The benchmark of the PyTorch and CUDA port (`adt_str_tpu_torch`) on one
NVIDIA H100: `python -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` from the root of a checkout. `BENCHMARK.json`
lists the cells; each cell's configuration, traffic mix and per-layer
metric sit in files of their own here, found by name."""
