"""Per-layer metrics, one reader a file (`<metric name>.py`, found by the
name in BENCHMARK.json): `read(run)` returns the metric's value, or None
where the run gave it nothing to read."""
