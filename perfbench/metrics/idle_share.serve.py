"""Share of the traced stretch's wall time in which no operation ran on
the device: 100 * (1 - union of the device operations' intervals / wall).
Named ranges (user annotations) are left out of the union."""


def read(view):
    s = view.stretch
    if not s.ops or s.wall_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.wall_s)
