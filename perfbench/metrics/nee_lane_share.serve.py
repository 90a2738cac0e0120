"""Share of the shadow query's lanes that sample a light: 100 * the
program's counter ``nee.lanes`` / ``shadow.lanes``, over the span pass's
frames."""


def read(view):
    c = view.counters
    if not c or not c.get("shadow.lanes"):
        return None
    return 100.0 * c.get("nee.lanes", 0) / c["shadow.lanes"]
