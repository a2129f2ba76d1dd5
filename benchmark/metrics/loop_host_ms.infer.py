"""Mean host ms a batch of the launching loop's own spans, outside the
infer function and the fetch: serve collect + stack + h2d + answer, eval
IO wait + stack + h2d + records (the program's spans, for the batches
that start in the window and ran a forward)."""

LOOP = ('serve.collect', 'serve.stack', 'serve.h2d', 'serve.answer',
        'eval.io_wait', 'eval.stack', 'eval.h2d', 'eval.records')


def read(rec):
    try:
        from offsetguided_tpu_torch.utils.profiling import RECORDER
    except ImportError:             # a program without the recorder
        return None
    w = RECORDER.window(rec['t0'], rec['t0'] + rec['seconds'])
    runs = [b for b in w.batches.values() if 'infer.forward' in b]
    if not runs:
        return None
    return sum(b.get(n, 0.0) for b in runs for n in LOOP) / len(runs) * 1e3
