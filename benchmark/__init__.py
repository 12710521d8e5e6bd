"""The benchmark of the PyTorch and CUDA port (mauvealigner_tpu_torch).

run.py runs one cell for one seed; everything that belongs to a
configuration, a traffic mix, a cell or a metric is a file of its own here,
found by the name BENCHMARK.json gives it (spec.py)."""
