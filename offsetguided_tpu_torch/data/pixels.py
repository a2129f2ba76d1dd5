"""OpenCV's uint8 pixel kernels of the host augmentation, in numpy.

The JAX package warps, grays and tints training samples with cv2
(`cv2.warpAffine(..., INTER_CUBIC, BORDER_CONSTANT)`,
`cv2.cvtColor(RGB2GRAY / RGB2HSV / HSV2RGB)`). The card's host has no
OpenCV, so these reproduce the values OpenCV 5.0 computes, value for
value (pinned by fuzzing against it, `tests/test_torch_port_host_aug.py`):

- `warp_affine_u8`: OpenCV inverts the 2x3 matrix in double precision,
  maps each output pixel to the source in float32 (`m0*x + (m1*y + m2)`,
  no fused multiply-add), and takes the cubic (A = -0.75) weights of the
  float32 fraction t as `A*(t*((1-t)*(1-t)))`, `fma(fma(A+2, t, -(A+3)),
  t*t, 1)`, the remainder, and `A*((1-t)*(t*t))`. Each of the four rows
  is a chain of fused multiply-adds over its taps (left to right), and
  the rows are chained the same way top to bottom; taps outside the
  source read the border value, and a pixel with no tap inside is the
  border value. The float32 result is rounded half to even and saturated.
  (OpenCV 4's fixed-point remap, with coordinates rounded to 1/32 pixel,
  differs from this on about one value in ten.)
- `rgb_to_gray_u8`: fixed point, (9798 R + 19235 G + 3735 B + 2^14) >> 15.
- `rgb_to_hsv_u8` / `hsv_to_rgb_u8`: the uint8 conversions with hue in
  [0, 180): fixed-point division tables one way; the other, float32
  sectors (`v * fma(-s, f, 1)`) scaled by 255, truncated in each row's
  32-pixel vector blocks and rounded in its tail. Both hold over every one
  of their 2^24 and 180 * 2^16 inputs, in blocks and in tails.

`warp_affine_u8_native` computes `warp_affine_u8` in C++ with the same
operation order (`csrc/host_warp.cpp`, called through ctypes, which
releases the GIL); the loader uses it, and the numpy version is the
definition the tests hold it to.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

f32 = np.float32
_A = f32(-0.75)


def invert_affine(m) -> Tuple[float, ...]:
    """cv2.warpAffine's inversion of a forward 2x3 matrix, in double
    precision and in its operation order: (a, b, c, d, e, f) with
    src_x = a x + b y + c, src_y = d x + e y + f."""
    m0, m1, m2, m3, m4, m5 = (float(v) for v in
                              np.asarray(m, np.float64).reshape(-1)[:6])
    det = m0 * m4 - m1 * m3
    det = 1.0 / det if det != 0 else 0.0
    a11, a22 = m4 * det, m0 * det
    m0, m1, m3, m4 = a11, m1 * -det, m3 * -det, a22
    return (m0, m1, -m0 * m2 - m1 * m5, m3, m4, -m3 * m2 - m4 * m5)


def fma32(a, b, c) -> np.ndarray:
    """float32 fused multiply-add, correctly rounded: a*b is exact in
    double, a*b + c is split into its double sum and exact error
    (TwoSum), and a sum that lands on a float32 midpoint is pushed to the
    side its error lies on."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    r = s.astype(f32)
    lo = np.where(r.astype(np.float64) > s, np.nextafter(r, f32(-np.inf)), r)
    hi = np.nextafter(lo, f32(np.inf))
    mid = (lo.astype(np.float64) + hi.astype(np.float64)) * 0.5
    tie = (s == mid) & (err != 0)
    if tie.any():
        r = np.where(tie, np.where(err > 0, hi, lo), r)
    return r


def cubic_weights(t: np.ndarray):
    """OpenCV's float32 cubic weights of the taps at -1, 0, 1, 2 for the
    fraction t in [0, 1)."""
    one = f32(1)
    u = one - t
    tt = t * t
    w0 = _A * (t * (u * u))
    w1 = fma32(_A + f32(2), t, -(_A + f32(3)))
    w1 = fma32(w1, tt, one)
    w3 = _A * (u * tt)
    w2 = ((one - w0) - w1) - w3
    return w0, w1, w2, w3


def _border(border, c: int) -> np.ndarray:
    b = np.asarray(border, f32).reshape(-1)
    return np.ascontiguousarray(np.broadcast_to(b[:c] if b.size > 1 else b,
                                                (c,)))


def warp_affine_u8(src: np.ndarray, m, out_w: int, out_h: int,
                   border) -> np.ndarray:
    """cv2.warpAffine(src, m, (out_w, out_h), flags=INTER_CUBIC,
    borderMode=BORDER_CONSTANT, borderValue=border) for uint8 (H, W) or
    (H, W, C) `src` and a forward 2x3 `m`."""
    squeeze = src.ndim == 2
    s = src[:, :, None] if squeeze else src
    h, w, c = s.shape
    bval = _border(border, c)
    a, b, cc, d, e, f = (f32(v) for v in invert_affine(m))
    xs = np.arange(out_w, dtype=f32)[None, :]
    ys = np.arange(out_h, dtype=f32)[:, None]
    sx = a * xs + (b * ys + cc)
    sy = d * xs + (e * ys + f)
    fx, fy = np.floor(sx), np.floor(sy)
    wx = cubic_weights(sx - fx)
    wy = cubic_weights(sy - fy)
    ix = np.clip(fx, -8, w + 8).astype(np.int64) - 1
    iy = np.clip(fy, -8, h + 8).astype(np.int64) - 1
    pad = np.empty((h + 2, w + 2, c), f32)     # one border pixel around
    pad[...] = bval
    pad[1:-1, 1:-1] = s
    acc = None
    for i in range(4):
        ty = np.clip(iy + i, -1, h) + 1
        row = None
        for j in range(4):
            v = pad[ty, np.clip(ix + j, -1, w) + 1]
            row = (v * wx[j][..., None] if row is None
                   else fma32(v, wx[j][..., None], row))
        acc = (row * wy[i][..., None] if acc is None
               else fma32(row, wy[i][..., None], acc))
    outside = (ix + 3 < 0) | (ix >= w) | (iy + 3 < 0) | (iy >= h)
    acc = np.where(outside[..., None], bval, acc)
    out = np.clip(np.rint(acc), 0, 255).astype(np.uint8)
    return out[..., 0] if squeeze else out


def warp_affine_u8_native(src: np.ndarray, m, out_w: int, out_h: int,
                          border) -> np.ndarray:
    """`warp_affine_u8` computed by its C++ twin (`csrc/host_warp.cpp`,
    built at first use; a failed build raises)."""
    from ..ops.cuda import _build
    lib = _build.library('host_warp')
    s = np.ascontiguousarray(src[:, :, None] if src.ndim == 2 else src,
                             dtype=np.uint8)
    h, w, c = s.shape
    inv = np.asarray(invert_affine(m), f32)
    bval = _border(border, c)
    out = np.empty((out_h, out_w, c), np.uint8)
    if lib.og_warp_affine_u8(s.ctypes.data, h, w, c, inv.ctypes.data,
                             bval.ctypes.data, out.ctypes.data, out_h,
                             out_w) != 0:
        raise RuntimeError('og_warp_affine_u8 failed')
    return out[..., 0] if src.ndim == 2 else out


def rgb_to_gray_u8(image: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(image, COLOR_RGB2GRAY) for uint8 (H, W, 3)."""
    x = image.astype(np.int32)
    y = x[..., 0] * 9798 + x[..., 1] * 19235 + x[..., 2] * 3735
    return ((y + (1 << 14)) >> 15).astype(np.uint8)


_HSV_SHIFT = 12
_SDIV = np.zeros(256, np.int64)
_SDIV[1:] = np.rint((255 << _HSV_SHIFT) / np.arange(1, 256, dtype=np.float64))
_HDIV = np.zeros(256, np.int64)
_HDIV[1:] = np.rint((180 << _HSV_SHIFT)
                    / (6.0 * np.arange(1, 256, dtype=np.float64)))


def rgb_to_hsv_u8(image: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(image, COLOR_RGB2HSV) for uint8 (H, W, 3): hue in
    [0, 180), fixed-point division tables."""
    x = image.astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    hue = np.where(v == r, g - b,
                   np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    hue = (hue * _HDIV[diff] + half) >> _HSV_SHIFT
    hue = np.where(hue < 0, hue + 180, hue)
    return np.stack([hue, s, v], axis=-1).astype(np.uint8)


_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(hsv, COLOR_HSV2RGB) for uint8 (H, W, 3) with hue in
    [0, 180): float32 sectors scaled by 255. OpenCV converts each row in
    vector blocks of 32 pixels, which truncate, and the row's last
    W mod 32 pixels one by one, which round half to even."""
    x = hsv.astype(f32)
    h = x[..., 0] * f32(6.0 / 180.0)
    s = x[..., 1] * f32(1.0 / 255.0)
    v = x[..., 2] * f32(1.0 / 255.0)
    h = np.where(h >= 6, h - f32(6), h)
    sector = np.floor(h).astype(np.int64)
    frac = h - sector.astype(f32)
    one = f32(1)
    tab = np.stack([v, v * (one - s), v * fma32(-s, frac, one),
                    v * fma32(-s, one - frac, one)], axis=-1)
    idx = _SECTORS[np.clip(sector, 0, 5)]           # (..., 3): b, g, r
    bgr = np.take_along_axis(tab, idx, axis=-1)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr)
    rgb = bgr[..., ::-1] * f32(255)
    w = hsv.shape[1]
    blocked = (np.arange(w) < w - w % 32)[:, None]
    rgb = np.where(blocked, np.trunc(rgb), np.rint(rgb))
    return np.clip(rgb, 0, 255).astype(np.uint8)

