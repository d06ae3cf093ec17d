"""The benchmark of `repro_torch`: a data-driven harness (`run.py`) that
runs one cell of `BENCHMARK.json` once on the GPU and prints one JSON
result line.  Nothing here imports `jax`, `repro` or anything under
`benchmarks/`."""
