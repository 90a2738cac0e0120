"""Device milliseconds per served frame of next-event estimation outside
its shadow query: what was launched with ``nee`` or ``nee.tables`` as the
innermost span (the light sample, MIS's weights, the light table), over
the span pass's frames; the shadow query under ``nee`` is
shadow_ms.serve's."""

from perfbench import trace

SPANS = ("nee", "nee.tables")


def read(view):
    return trace.own_ms(view.span_ms, SPANS)
