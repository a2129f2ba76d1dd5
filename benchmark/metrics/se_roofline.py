"""The squeeze-and-excitation layers' share (%) of their roofline over the
window: each `net.se` record's bound is its input map read twice (the
mean, the scale) and its output written once, 3 x N*C*H*W elements of
the map's type at the HBM peak; the share is the records' summed bound
over their summed device time. The layer is memory-bound: its Linear
layers are a few hundred kFLOP."""
import math

import torch

from kernels import PEAK_BYTES
from program_stages import records


def read(rec):
    recs = records(rec, 'net.se')
    seconds = sum(r.ms for r in recs) / 1e3
    if not recs or seconds <= 0:
        return None
    n_bytes = sum(3 * math.prod(r.shape) * getattr(torch, r.dtype).itemsize
                  for r in recs)
    return 100.0 * n_bytes / PEAK_BYTES / seconds
