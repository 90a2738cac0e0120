"""Device milliseconds per served frame of alive-lane compaction (each
later bounce's partition, and the final restore): what was launched with
``compact`` as the innermost span, over the span pass's frames."""

from perfbench import trace


def read(view):
    return trace.own_ms(view.span_ms, ("compact",))
