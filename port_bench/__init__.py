"""The benchmark of `vitadapter_torch`, the PyTorch and CUDA port: one
command runs one cell (`run.py`), the cells, metrics and bounds live in
`BENCHMARK.json` at the checkout's root, and everything that belongs to
one configuration, traffic mix, cell or per-layer metric is a file of its
own here (`configs/`, `traffic/`, `limits/`, `metrics/`)."""
