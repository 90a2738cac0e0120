"""Device milliseconds per served frame of the cluster sweep's glue around
its kernels: what was launched with ``sweep.sort``, ``sweep.cull`` (C1
among it) or ``sweep.reshade`` as the innermost span, over the span
pass's frames."""

from perfbench import trace

SPANS = ("sweep.sort", "sweep.cull", "sweep.reshade")


def read(view):
    return trace.own_ms(view.span_ms, SPANS)
