"""Device milliseconds per served frame of the closest-hit queries: what
the program launched inside its ``intersect`` spans (any backend: the
boxes' brute force with H1, the bunny's sphere search, sort, cull, B1 and
re-shade), nested spans included, over the span pass's frames."""


def read(view):
    if view.span_ms is None:
        return None
    return view.span_ms["device"].get("intersect")
