"""The PyTorch and CUDA port's benchmark: `run.py` runs one cell of
`BENCHMARK.json` once; `harness.py` says how cells, configurations,
traffic mixes and per-layer metrics are found by name."""
