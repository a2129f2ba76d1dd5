"""95th percentile of the request latency (submit to answer), over every
request completed in the window; a failed request counts as infinite."""
from loadgen import percentile


def read(rec):
    lats = rec.get('latencies')
    return percentile(lats, 0.95) * 1e3 if lats else None
