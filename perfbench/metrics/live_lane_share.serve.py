"""Share of the lanes handed to the closest-hit queries that were live:
100 * the program's counter ``intersect.alive`` / ``intersect.lanes``,
over the span pass's frames."""


def read(view):
    c = view.counters
    if not c or not c.get("intersect.lanes"):
        return None
    return 100.0 * c.get("intersect.alive", 0) / c["intersect.lanes"]
