"""Share of the lanes that compaction handed to its bounces that were dead
padding: 100 * (1 - the program's counter ``compact.alive`` /
``compact.kept``), over the span pass's frames."""


def read(view):
    c = view.counters
    if not c or not c.get("compact.kept"):
        return None
    return 100.0 * (1.0 - c.get("compact.alive", 0) / c["compact.kept"])
