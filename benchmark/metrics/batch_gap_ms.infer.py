"""Mean device ms idle between two consecutive batches of the launching
loop that both start in the window: CUDA events after a batch's last
launch and before the next batch's first copy, the program samples one
gap in four batches (its gap counter; none on a CPU device)."""


def read(rec):
    try:
        from offsetguided_tpu_torch.utils.profiling import RECORDER
    except ImportError:             # a program without the recorder
        return None
    gaps = RECORDER.window(rec['t0'], rec['t0'] + rec['seconds']).gaps
    return sum(g.ms for g in gaps) / len(gaps) if gaps else None
