"""Percent of the traced stretch in which no device operation ran."""


def read(rec):
    t = rec.get('trace')
    if t is None or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
