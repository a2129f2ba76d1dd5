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
- `resize_cubic_u8`: `cv2.resize(src, (w, h), interpolation=INTER_CUBIC)`,
  which OpenCV 5.0 hands to Intel IPP for sources of at least 4 x 4. Each
  axis maps output i to the source at (i + 0.5) * n_in / n_out - 0.5 in
  double precision; the fraction t is rounded to float32 and then to a
  multiple of 2^-23, and the four weights are the double cubic kernel
  (A = -0.75) at t + 1, t, 1 - t and 2 - t, rounded to float32; taps
  outside the source repeat its edge. The rows are resized first, into
  float32: three channels by a chain of fused multiply-adds left to
  right, one channel by the rounded products summed in pairs, (w0 v0 +
  w1 v1) + (w2 v2 + w3 v3). The columns follow, fma(v0, w0, v1 w1) +
  fma(v2, w2, v3 w3), and the result is rounded half to even and
  saturated. (Below 4 pixels a side cv2 uses its own fixed-point resize,
  which this differs from by at most one grey level.)
- `rgb_to_gray_u8`: fixed point, (9798 R + 19235 G + 3735 B + 2^14) >> 15.
- `rgb_to_hsv_u8` / `hsv_to_rgb_u8`: the uint8 conversions with hue in
  [0, 180): fixed-point division tables one way; the other, float32
  sectors (`v * fma(-s, f, 1)`) scaled by 255, truncated in each row's
  32-pixel vector blocks and rounded in its tail. Both hold over every one
  of their 2^24 and 180 * 2^16 inputs, in blocks and in tails.

- `gaussian_blur_u8`: `cv2.GaussianBlur(src, (0, 0), sigma)` for uint8,
  OpenCV's bit-exact fixed-point path (IPP is not used for it). The
  kernel has cvRound(6 sigma + 1) | 1 taps; its double weights
  exp(-x^2 / (2 sigma^2)) / sum are scaled to 8 fraction bits with the
  rounding error carried from tap to tap (round half even), the centre
  tap taking what is left of 256. Rows and then columns are filtered in
  exact integer arithmetic (taps outside the image reflected about the
  edge pixel, BORDER_REFLECT_101), and the 16-fraction-bit sum is rounded
  half up. An axis of length 1 is not filtered. Pinned by fuzzing
  against cv2 (`tests/test_torch_port_transforms.py`).

`warp_affine_u8_native` and `resize_cubic_u8_native` compute
`warp_affine_u8` and `resize_cubic_u8` in C++ with the same operation
order (`csrc/host_warp.cpp`, called through ctypes, which releases the
GIL); the loader and the evaluation's rescale use them, and the numpy
versions are the definitions the tests hold them to.
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


def _keys(t: np.ndarray) -> np.ndarray:
    """The cubic kernel (A = -0.75) at 0 <= t <= 2, in double precision."""
    a = -0.75
    return np.where(t <= 1, ((a + 2) * t - (a + 3)) * t * t + 1,
                    ((a * t - 5 * a) * t + 8 * a) * t - 4 * a)


def resize_taps(n_in: int, n_out: int):
    """One axis of `resize_cubic_u8`: the four source taps of each output,
    clamped to the source, (4, n_out), and their float32 weights."""
    pos = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    lo = np.floor(pos)
    t = (pos - lo).astype(f32).astype(np.float64)
    t = np.round(t * 2.0 ** 23) * 2.0 ** -23
    w = np.stack([_keys(t + 1), _keys(t), _keys(1 - t), _keys(2 - t)])
    taps = lo.astype(np.int64)[None] + np.arange(-1, 3)[:, None]
    return np.clip(taps, 0, n_in - 1), w.astype(f32)


def _resize_channels(src: np.ndarray) -> np.ndarray:
    s = src[:, :, None] if src.ndim == 2 else src
    if s.shape[2] not in (1, 3) or min(s.shape[:2]) < 1:
        raise ValueError(f'resize_cubic_u8 takes (H, W), (H, W, 1) or '
                         f'(H, W, 3) uint8; got {src.shape}')
    return s


def resize_cubic_u8(src: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """cv2.resize(src, (out_w, out_h), interpolation=INTER_CUBIC) for
    uint8 (H, W), (H, W, 1) or (H, W, 3) `src` of at least 4 x 4."""
    s = _resize_channels(src)
    h, w, c = s.shape
    tx, wx = resize_taps(w, out_w)
    ty, wy = resize_taps(h, out_h)
    x = s.astype(f32)
    v = [x[:, tx[j]] for j in range(4)]
    k = [wx[j][None, :, None] for j in range(4)]
    if c == 3:
        rows = v[0] * k[0]
        for j in range(1, 4):
            rows = fma32(v[j], k[j], rows)
    else:
        rows = (v[0] * k[0] + v[1] * k[1]) + (v[2] * k[2] + v[3] * k[3])
    r = [rows[ty[i]] for i in range(4)]
    k = [wy[i][:, None, None] for i in range(4)]
    acc = fma32(r[0], k[0], r[1] * k[1]) + fma32(r[2], k[2], r[3] * k[3])
    out = np.clip(np.rint(acc), 0, 255).astype(np.uint8)
    return out.reshape(out_h, out_w, *src.shape[2:])


def resize_cubic_u8_native(src: np.ndarray, out_w: int,
                           out_h: int) -> np.ndarray:
    """`resize_cubic_u8` computed by its C++ twin (`csrc/host_warp.cpp`,
    built at first use; a failed build raises)."""
    from ..ops.cuda import _build
    lib = _build.library('host_warp')
    s = np.ascontiguousarray(_resize_channels(src), dtype=np.uint8)
    h, w, c = s.shape
    out = np.empty((out_h, out_w, c), np.uint8)
    if lib.og_resize_cubic_u8(s.ctypes.data, h, w, c, out.ctypes.data,
                              out_h, out_w) != 0:
        raise RuntimeError('og_resize_cubic_u8 failed')
    return out.reshape(out_h, out_w, *src.shape[2:])


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


def gaussian_ksize_u8(sigma: float) -> int:
    """The taps OpenCV gives an 8-bit Gaussian of `sigma`:
    cvRound(sigma * 3 * 2 + 1) | 1 (cvRound rounds half to even)."""
    return int(np.rint(sigma * 3 * 2 + 1)) | 1


def gaussian_kernel_q8(n: int, sigma: float) -> np.ndarray:
    """OpenCV's `n`-tap fixed-point Gaussian for 8-bit images: int64
    weights in units of 2^-8 summing to 256 (`getGaussianKernelBitExact`
    then `getGaussianKernelFixedPoint_ED`, in double precision)."""
    scale2 = -0.125 / (sigma * sigma)      # x counts half-taps
    half = (n - 1) // 2
    values, total = [], 0.0
    for x in range(1 - n, 1 - n + 2 * half, 2):
        values.append(float(np.exp(float(x * x) * scale2)))
        total += values[-1]
    mul = 1.0 / (total * 2.0 + 1.0)
    out = np.zeros(n, np.int64)
    err = 0.0
    for i, v in enumerate(values):
        adj = v * mul * 256.0 + err
        q = int(np.rint(adj))
        err = adj - q
        out[i] = out[n - 1 - i] = q
    out[half] = 256 - 2 * int(out[:half].sum())
    return out


def reflect101(n_taps: int, length: int) -> np.ndarray:
    """Source index of each of the `length + n_taps - 1` positions a
    centred `n_taps` filter reads, reflected about the edge pixels
    (BORDER_REFLECT_101, reflected again until inside)."""
    p = np.arange(-(n_taps // 2), length + n_taps // 2)
    if length == 1:
        return np.zeros_like(p)
    period = 2 * (length - 1)
    p = np.abs(p) % period
    return np.where(p < length, p, period - p)


def _smooth_axis(x: np.ndarray, k: np.ndarray, axis: int) -> np.ndarray:
    """sum_i k[i] x[reflect(j + i - r)] along `axis`, in int32, the
    symmetric taps paired."""
    n, length = len(k), x.shape[axis]
    if length == 1:
        return x << 8
    pad = np.take(x, reflect101(n, length), axis=axis)

    def at(i):
        return pad[(slice(None),) * axis + (slice(i, i + length),)]
    r = n // 2
    acc = at(r) * np.int32(k[r])
    for i in range(r):
        acc += (at(i) + at(n - 1 - i)) * np.int32(k[i])
    return acc


def gaussian_blur_u8(src: np.ndarray, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(src, (0, 0), sigma) for uint8 (H, W) or (H, W, C)
    `src`, sigma > 0; (H, W, 1) gives (H, W), as cv2 does."""
    src = np.asarray(src)
    if src.dtype != np.uint8 or src.ndim not in (2, 3) or src.size == 0:
        raise ValueError(f'gaussian_blur_u8 takes a non-empty uint8 (H, W) '
                         f'or (H, W, C) image; got {src.dtype} {src.shape}')
    if not sigma > 0:
        raise ValueError(f'gaussian_blur_u8 needs sigma > 0; got {sigma}')
    k = gaussian_kernel_q8(gaussian_ksize_u8(sigma), sigma)
    x = src.reshape(src.shape[0], src.shape[1], -1).astype(np.int32)
    acc = _smooth_axis(_smooth_axis(x, k, 1), k, 0)
    out = ((acc + (1 << 15)) >> 16).astype(np.uint8)
    return out[..., 0] if src.ndim == 2 or src.shape[2] == 1 else out
