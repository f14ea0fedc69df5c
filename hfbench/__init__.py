"""Benchmark of pyrayhf_tpu_torch on one CUDA card: ``hfbench/run.py``.

Everything that belongs to one configuration, traffic mix, entry point or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``configs/<config>.json`` — a deployment's sizes and source;
* ``traffic/<mix>.json`` — the parameters the one input generator reads;
* ``entries/<entry>.py`` — the call into the program, its plain reference,
  and its work count for the roofline;
* ``metrics/<metric>.py`` — a reader of one per-layer metric.
"""
