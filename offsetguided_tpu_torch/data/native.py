"""ctypes bindings of the COCO RLE codec `csrc/rle.cpp`, built with the host
C++ compiler by `ops/cuda/_build.py` on first use (a failed build raises).

The port's counterpart of the JAX package's `data/native.py`, with the
same entry points: `available` says whether the C decoder loads,
`rle_string_to_mask` decodes a compressed counts string into a row-major
uint8 mask (None where the C decoder refuses the string, so the caller
falls back to the Python decoder as the JAX package does),
`rle_encode_mask` encodes a mask into column-major run lengths."""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np


def _lib():
    from ..ops.cuda import _build
    return _build.library('rle')


def available() -> bool:
    """Whether the C decoder loads: True once it is built and loaded. A
    failed build raises, as every call of the decoder does, instead of
    answering False."""
    return _lib() is not None


def rle_string_to_mask(counts: str, h: int, w: int) -> Optional[np.ndarray]:
    """Compressed RLE string -> uint8 (h, w) mask, or None where the C
    decoder returns an error."""
    mask = np.zeros((h, w), dtype=np.uint8)
    raw = counts.encode('ascii')
    rc = _lib().rle_string_to_mask(raw, len(raw), h, w,
                                   mask.ctypes.data_as(ctypes.c_void_p))
    return mask if rc == 0 else None


def rle_encode_mask(mask: np.ndarray) -> Optional[np.ndarray]:
    """uint8 (h, w) mask -> uint32 column-major run lengths, or None where
    the runs overflow their buffer."""
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    h, w = mask.shape
    runs = np.zeros(h * w + 2, dtype=np.uint32)
    n = _lib().rle_mask_to_runs(mask.ctypes.data_as(ctypes.c_void_p), h, w,
                                runs.ctypes.data_as(ctypes.c_void_p),
                                len(runs))
    return runs[:n].copy() if n >= 0 else None
