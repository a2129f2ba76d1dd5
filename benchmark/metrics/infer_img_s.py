"""Images answered in the window over the window's seconds."""


def read(rec):
    return rec['images'] / rec['seconds'] if rec.get('seconds') else None
