"""Per-layer readers, one file each, named as the metric in BENCHMARK.json.

Each has `read(rec) -> float | None` over the traced chunk's record (see
trace.py and drivers/adam.py for its keys, and `config`, the configuration
file). A reader that finds nothing to read returns None, and the metric is
left out of the run's line."""
