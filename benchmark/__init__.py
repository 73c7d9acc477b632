"""The port's benchmark: one data-driven harness over the cells of the
repository's BENCHMARK.json (see harness.py)."""
