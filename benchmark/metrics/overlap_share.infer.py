"""Share (%) of the launching loop's batches that start in the window and
were enqueued while the loop's previous batch was still in flight on the
device: `run_images` queries the previous batch's output event, without
a sync, once this batch's input copy is enqueued (the program's overlap
counter; a program without it, or a window without its records, gives
nothing)."""


def read(rec):
    try:
        from offsetguided_tpu_torch.utils.profiling import RECORDER
    except ImportError:             # a program without the recorder
        return None
    w = RECORDER.window(rec['t0'], rec['t0'] + rec['seconds'])
    flags = getattr(w, 'overlaps', None)
    if not flags:
        return None
    return 100.0 * sum(1 for f in flags if f.in_flight) / len(flags)
