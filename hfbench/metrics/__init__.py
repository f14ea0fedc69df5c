"""Per-layer metric readers, one module per metric, named as in
``BENCHMARK.json``, which gives each its layer, unit and the end-to-end
metric it should move. Each has ``read(summary)``, which returns
the metric's value from a traced run's summary (``timeline``), or None
where the summary holds nothing to read it from."""
