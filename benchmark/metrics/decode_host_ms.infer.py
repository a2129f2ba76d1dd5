"""Mean host ms of the infer function's `infer.decode` span a batch: the
time to issue the decoder's launches (the program's spans, for the
batches that start in the window); read against `decode_ms.infer`, its
device time."""


def read(rec):
    try:
        from offsetguided_tpu_torch.utils.profiling import RECORDER
    except ImportError:             # a program without the recorder
        return None
    w = RECORDER.window(rec['t0'], rec['t0'] + rec['seconds'])
    ms = [b['infer.decode'] for b in w.batches.values()
          if 'infer.decode' in b]
    return sum(ms) / len(ms) * 1e3 if ms else None
