"""Requests per device batch of the Batcher over the window (its own
counters)."""


def read(rec):
    b = rec.get('batches')
    return rec['requests'] / b if b else None
