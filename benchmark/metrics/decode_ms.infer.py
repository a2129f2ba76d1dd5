"""Device ms a decode: the kernels launched inside the decoder's spans
(flip merge, peaks, limb collection, grouping), over the decodes
traced."""


def read(rec):
    t = rec.get('trace')
    n = t.n_spans('bench.decode') if t is not None else 0
    return t.layer_seconds('bench.decode') / n * 1e3 if n else None
