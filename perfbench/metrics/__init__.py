"""Per-layer metric readers, one file per metric of BENCHMARK.json's
``per_layer`` list, named as the metric and found by that name.

Each defines ``read(view) -> float | None``; ``view`` is a
``perfbench.harness.MetricView`` of one traced run.  A reader that finds
nothing to read returns None, and the metric is left out of the result.
"""
