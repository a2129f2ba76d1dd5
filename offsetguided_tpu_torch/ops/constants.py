"""Host constants that the decode, the grouping kernel and the normalization
read on the device, copied there once.

A tensor built on the card from host data is a copy from pageable memory,
and PyTorch waits for the stream's queued work before such a copy
returns. Built anew on every call, the limb ends, channel groups, flip
permutations, the grouping kernel's skeleton and the ImageNet mean and std
would each hold the host until the forward before them had drained.
`on_device` builds each (device, dtype, values) once and hands the same
tensor to every later call.

While `torch.compile` or `torch.export` traces, the call builds the tensor
afresh and neither reads nor fills the cache: no tensor of a trace reaches
an eager call, and a trace holds the constant as the eager code builds it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_cache: Dict[Tuple, torch.Tensor] = {}


def on_device(values, device: torch.device,
              dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """`torch.tensor(values, dtype=dtype, device=device)` for a sequence or
    array, built once per (device, dtype, values) and shared by every later
    call: read it, never write to it. Built outside inference mode, so
    autograd code may read it too."""
    a = np.asarray(values)
    if torch.compiler.is_compiling():
        return torch.tensor(a, dtype=dtype, device=device)
    key = (torch.device(device), dtype, a.shape, a.dtype.str, a.tobytes())
    t = _cache.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = torch.tensor(a, dtype=dtype, device=device)
        _cache[key] = t
    return t
