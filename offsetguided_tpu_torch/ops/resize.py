"""Integer-factor upsampling with `F.interpolate` semantics (half-pixel,
edge clamp; bicubic A=-0.75, bilinear, nearest) in a fixed term order.

An integer factor `s` has `s` fractional phases per axis, so each output
phase is a fixed weighted sum of edge-clamped shifted copies of the source.
The sums run in one order everywhere: the H pass, then the W pass, taps in
offset order, exact-zero taps skipped, each term a separate multiply and
add. The peaks kernel (`csrc/peaks.cu`) repeats that order with
`__fmul_rn`/`__fadd_rn`, so its values bit-match this function.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic_kernel(d: np.ndarray, a: float = -0.75) -> np.ndarray:
    d = np.abs(d)
    return np.where(
        d <= 1.0,
        (a + 2.0) * d ** 3 - (a + 3.0) * d ** 2 + 1.0,
        np.where(d < 2.0,
                 a * d ** 3 - 5.0 * a * d ** 2 + 8.0 * a * d - 4.0 * a, 0.0))


@functools.lru_cache(maxsize=32)
def phase_table(factor: int, method: str) -> tuple[np.ndarray, np.ndarray]:
    """Per-phase `(offsets (n_taps,), weights (factor, n_taps))`: tap
    positions relative to the source cell, and each phase's weights."""
    phases = (np.arange(factor) + 0.5) / factor - 0.5
    base = np.floor(phases).astype(np.int64)
    frac = phases - base
    if method == 'bicubic':
        rel = np.arange(-1, 3)
        weights = _cubic_kernel(rel[None, :] - frac[:, None])
    elif method == 'bilinear':
        rel = np.arange(0, 2)
        weights = np.maximum(0.0, 1.0 - np.abs(rel[None, :] - frac[:, None]))
    elif method == 'nearest':
        rel = np.arange(0, 1)
        weights = np.ones((factor, 1))
        base = np.floor(phases + 0.5).astype(np.int64)
    else:
        raise ValueError(f'unknown resize method: {method}')
    min_off = int(base.min() + rel.min())
    max_off = int(base.max() + rel.max())
    offsets = np.arange(min_off, max_off + 1)
    full = np.zeros((factor, offsets.size))
    for p in range(factor):
        for t, r in enumerate(rel):
            full[p, base[p] + r - min_off] += weights[p, t]
    return offsets, full


def phase_taps(factor: int, method: str):
    """[phase] -> [(offset, float32 weight)] without the zero taps."""
    offsets, weights = phase_table(factor, method)
    return [[(int(off), float(np.float32(weights[p, t])))
             for t, off in enumerate(offsets) if float(weights[p, t]) != 0.0]
            for p in range(factor)]


def upsample_axis(x: torch.Tensor, axis: int, factor: int,
                  method: str) -> torch.Tensor:
    """Upsample one axis by an integer factor with half-pixel alignment."""
    if factor == 1:
        return x
    axis = axis % x.ndim
    n = x.shape[axis]
    idx = torch.arange(n, device=x.device)
    parts = []
    for taps in phase_taps(factor, method):
        acc = None
        for off, wt in taps:
            src = x.index_select(axis, (idx + off).clamp(0, n - 1))
            # the float32 weight as a Python float: on float32 maps the
            # product of a 0-d tensor of it, without a copy to the device
            term = src * wt
            acc = term if acc is None else acc + term
        parts.append(acc)
    stacked = torch.stack(parts, dim=axis + 1)
    shape = list(x.shape)
    shape[axis] = n * factor
    return stacked.reshape(shape)


def upsample2d(x: torch.Tensor, factor: int, method: str = 'bicubic',
               h_axis: int = 1, w_axis: int = 2) -> torch.Tensor:
    """Upsample two spatial axes (default NHWC) by `factor`."""
    x = upsample_axis(x, h_axis, factor, method)
    return upsample_axis(x, w_axis, factor, method)
