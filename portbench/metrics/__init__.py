"""Per-layer metric readers, one module per metric, named as in BENCHMARK.json."""
