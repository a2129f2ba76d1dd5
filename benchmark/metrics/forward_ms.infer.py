"""Device ms a forward: the kernels launched inside the model's forward
spans, over the number of forwards traced."""


def read(rec):
    t = rec.get('trace')
    n = t.n_spans('bench.forward') if t is not None else 0
    return t.layer_seconds('bench.forward') / n * 1e3 if n else None
