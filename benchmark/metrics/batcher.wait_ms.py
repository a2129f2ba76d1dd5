"""95th percentile over the window's requests of their wait in the
Batcher's queue, from submit to the close of their batch (the program's
request records, for the batches that start in the window)."""
from loadgen import percentile


def read(rec):
    try:
        from offsetguided_tpu_torch.utils.profiling import RECORDER
    except ImportError:             # a program without the recorder
        return None
    w = RECORDER.window(rec['t0'], rec['t0'] + rec['seconds'])
    waits = [r.t_taken - r.t_submit for r in w.requests]
    return percentile(waits, 0.95) * 1e3 if waits else None
