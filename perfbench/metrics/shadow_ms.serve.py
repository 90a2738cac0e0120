"""Device milliseconds per served frame of next-event estimation's shadow
queries: what the program launched inside its ``shadow`` spans (the
sweep's sort, cull and B1 nested), over the span pass's frames."""


def read(view):
    if view.span_ms is None:
        return None
    return view.span_ms["device"].get("shadow")
