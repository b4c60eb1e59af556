"""The port's benchmark: one cell of `BENCHMARK.json` a run
(`portbench/run.py`). See `portbench/README.md`."""
