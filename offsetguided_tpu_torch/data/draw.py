"""Drawing into (H, W, 3) uint8 arrays, in place, in numpy.

cv2's drawing in its 16-bit fixed point, for the port's synthetic images
(the self-check's stick figures, the painted hard set): filled circles
(the same pixels as cv2.circle) and 3-pixel lines (a filled quadrilateral
with round caps, as cv2.line draws them; its edge rasterization rounds
differently from cv2's, so about one line in twelve gets two pixels
more). Colours are written as given.

Raster primitives for the pose painter (`visualization/show.py`), each
vectorized over its shapes: `segments` (any width, optionally dashed,
clipped to the image), `disks` and `rings`, `fill_polygon` (even-odd
rule), `fill_wedges` and `text` (a 3x5 bitmap font of the digits, `.`
and `-`). Each blends its colour over the pixels it covers once, at
`alpha`, rounding to uint8.
"""
from __future__ import annotations

import numpy as np

_SHIFT = 16
_ONE = 1 << _SHIFT
_HALF = _ONE >> 1


def _tdiv(a: int, b: int) -> int:
    """C integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    h, w = img.shape[:2]
    if 0 <= y < h and max(x1, 0) <= min(x2, w - 1):
        img[y, max(x1, 0):min(x2, w - 1) + 1] = color


def circle(img: np.ndarray, cx: int, cy: int, r: int, color) -> None:
    """cv2.circle(img, (cx, cy), r, color, -1): midpoint circle, filled by
    horizontal spans."""
    err, dx, dy, plus, minus = 0, r, 0, 1, 2 * r - 1
    while dx >= dy:
        for y, x1, x2 in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx,
                                                        cx + dx),
                          (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy,
                                                        cx + dy)):
            _hline(img, y, x1, x2, color)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _edge(img: np.ndarray, p1, p2, color) -> None:
    """A polygon edge between fixed-point points, pixel by pixel along its
    major axis."""
    h, w = img.shape[:2]
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    major_x = abs(dx) > abs(dy)
    if (dx if major_x else dy) < 0:
        x1, y1, x2, y2 = x2, y2, x1, y1
        dx, dy = -dx, -dy
    if major_x:
        step = _tdiv(dy << _SHIFT, abs(dx) | 1)
        count = (x2 >> _SHIFT) - (x1 >> _SHIFT)
    else:
        step = _tdiv(dx << _SHIFT, abs(dy) | 1)
        count = (y2 >> _SHIFT) - (y1 >> _SHIFT)
    x1 += _HALF
    y1 += _HALF
    pts = [((x2 + _HALF) >> _SHIFT, (y2 + _HALF) >> _SHIFT)]
    for k in range(count + 1):
        pts.append(((x1 >> _SHIFT) + k, (y1 + k * step) >> _SHIFT) if major_x
                   else ((x1 + k * step) >> _SHIFT, (y1 >> _SHIFT) + k))
    for x, y in pts:
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color


def _convex_poly(img: np.ndarray, v, color) -> None:
    """cv2's FillConvexPoly of fixed-point vertices: the edges, then the
    spans between the two edge walkers, row by row."""
    n = len(v)
    h, w = img.shape[:2]
    for i in range(n):
        _edge(img, v[i - 1], v[i], color)
    imin = min(range(n), key=lambda i: (v[i][1], i))
    ymin = (v[imin][1] + _HALF) >> _SHIFT
    ymax = min((max(p[1] for p in v) + _HALF) >> _SHIFT, h - 1)
    walkers = [dict(idx=imin, di=1, x=-_ONE, dx=0, ye=ymin),
               dict(idx=imin, di=n - 1, x=-_ONE, dx=0, ye=ymin)]
    y, edges = ymin, n
    while y <= ymax:
        for e in walkers:
            if y < e['ye']:
                continue
            i0, i1 = e['idx'], (e['idx'] + e['di']) % n
            while edges > 0:
                edges -= 1
                ty = (v[i1][1] + _HALF) >> _SHIFT
                if ty > y:
                    e.update(ye=ty, x=v[i0][0], idx=i1, dx=_tdiv(
                        (v[i1][0] - v[i0][0]) * 2 + (ty - y), 2 * (ty - y)))
                    break
                i0, i1 = i1, (i1 + e['di']) % n
            else:
                edges -= 1
        if edges < 0:
            break
        xl, xr = sorted(e['x'] for e in walkers)
        _hline(img, y, (xl + _HALF) >> _SHIFT, (xr + _HALF) >> _SHIFT, color)
        for e in walkers:
            e['x'] += e['dx']
        y += 1


def line3(img: np.ndarray, p, q, color) -> None:
    """cv2.line(img, p, q, color, thickness=3): a rectangle 2 pixels to
    either side of the segment and round caps of radius 2."""
    p0 = (int(p[0]) << _SHIFT, int(p[1]) << _SHIFT)
    p1 = (int(q[0]) << _SHIFT, int(q[1]) << _SHIFT)
    dx = (p0[0] - p1[0]) / _ONE
    dy = (p1[1] - p0[1]) / _ONE
    r2 = dx * dx + dy * dy
    if r2 > np.finfo(np.float64).eps:
        r = 2 * _ONE / np.sqrt(r2)      # (3 << 15) + 0.5 * _ONE for odd 3
        ox, oy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _convex_poly(img, [(p0[0] + ox, p0[1] + oy), (p0[0] - ox, p0[1] - oy),
                           (p1[0] - ox, p1[1] - oy), (p1[0] + ox, p1[1] + oy)],
                     color)
    for c in (p0, p1):
        circle(img, (c[0] + _HALF) >> _SHIFT, (c[1] + _HALF) >> _SHIFT, 2,
                color)


# --------------------------------------------------------------------------- #
# raster primitives of the painter
# --------------------------------------------------------------------------- #
def blend(img: np.ndarray, ys, xs, color, alpha: float = 1.0) -> None:
    """Blend `color` (3 values, 0..255) at `alpha` over the pixels (ys, xs)
    inside the image, each pixel once."""
    h, w = img.shape[:2]
    ys = np.asarray(ys, np.int64).ravel()
    xs = np.asarray(xs, np.int64).ravel()
    keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    flat = np.unique(ys[keep] * w + xs[keep])
    view = img.reshape(h * w, -1)
    color = np.asarray(color, np.float64).reshape(1, -1)
    if alpha >= 1.0:
        view[flat] = np.rint(color).astype(img.dtype)
        return
    old = view[flat].astype(np.float64)
    view[flat] = np.rint(old * (1.0 - alpha) + color * alpha).astype(img.dtype)


def _disk_offsets(radius: float) -> np.ndarray:
    """(K, 2) integer (dy, dx) offsets within `radius` of the center."""
    r = int(np.floor(radius))
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    keep = dy * dy + dx * dx <= radius * radius
    return np.stack([dy[keep], dx[keep]], axis=1)


def _clip_segments(p: np.ndarray, q: np.ndarray, h: int, w: int, pad: float):
    """Liang-Barsky clip of segments p -> q ((M, 2) xy) to the image box
    grown by `pad`: (t0, t1, keep), the parameters along the
    original segments, and the mask of segments that remain."""
    d = q - p
    t0 = np.zeros(len(p))
    t1 = np.ones(len(p))
    keep = np.isfinite(p).all(1) & np.isfinite(q).all(1)
    for axis, hi in ((0, w - 1 + pad), (1, h - 1 + pad)):
        for num, den in ((p[:, axis] + pad, -d[:, axis]),
                         (hi - p[:, axis], d[:, axis])):
            with np.errstate(divide='ignore', invalid='ignore'):
                t = num / den
            par = den == 0
            keep &= ~(par & (num < 0))
            t0 = np.where(~par & (den < 0), np.maximum(t0, t), t0)
            t1 = np.where(~par & (den > 0), np.minimum(t1, t), t1)
    keep &= t0 <= t1
    return t0, t1, keep


def segments(img: np.ndarray, p, q, color, width: float = 1.0,
             alpha: float = 1.0, dash=None) -> None:
    """Lines from p to q ((M, 2) xy each, or one point each) of `width`
    pixels, clipped to the image; `dash=(on, off)` in pixels draws them
    dashed from p on."""
    p = np.asarray(p, np.float64).reshape(-1, 2)
    q = np.asarray(q, np.float64).reshape(-1, 2)
    if len(p) == 0:
        return
    h, w = img.shape[:2]
    t0, t1, keep = _clip_segments(p, q, h, w, width)
    p, q, t0, t1 = p[keep], q[keep], t0[keep], t1[keep]
    d = q - p
    length = np.hypot(d[:, 0], d[:, 1])
    span = (t1 - t0) * length
    n = np.ceil(span * 2.0).astype(np.int64) + 1      # half-pixel steps
    seg = np.repeat(np.arange(len(p)), n)
    k = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    t = np.repeat(t0, n) + k / np.maximum(np.repeat(n - 1, n), 1) * \
        np.repeat(t1 - t0, n)
    if dash is not None:
        on, off = dash
        t_keep = np.fmod(t * length[seg], on + off) < on
        seg, t = seg[t_keep], t[t_keep]
    pts = p[seg] + t[:, None] * d[seg]
    offs = _disk_offsets(width / 2.0)
    ys = np.rint(pts[:, 1])[:, None] + offs[None, :, 0]
    xs = np.rint(pts[:, 0])[:, None] + offs[None, :, 1]
    blend(img, ys, xs, color, alpha)


def disks(img: np.ndarray, centers, radius: float, color,
          alpha: float = 1.0) -> None:
    """Filled disks of `radius` pixels at `centers` ((M, 2) xy)."""
    c = np.rint(np.asarray(centers, np.float64).reshape(-1, 2))
    c = c[np.isfinite(c).all(1)]
    offs = _disk_offsets(radius)
    blend(img, c[:, 1, None] + offs[None, :, 0],
          c[:, 0, None] + offs[None, :, 1], color, alpha)


def rings(img: np.ndarray, centers, radii, color, width: float = 1.0,
          alpha: float = 1.0) -> None:
    """Circle outlines of `radii` pixels (one each, or one for all) at
    `centers` ((M, 2) xy)."""
    c = np.asarray(centers, np.float64).reshape(-1, 2)
    r = np.broadcast_to(np.asarray(radii, np.float64), (len(c),))
    n = 64
    ang = np.linspace(0.0, 2.0 * np.pi, n + 1)
    pts = c[:, None, :] + r[:, None, None] * np.stack(
        [np.cos(ang), np.sin(ang)], axis=-1)[None]
    segments(img, pts[:, :-1].reshape(-1, 2), pts[:, 1:].reshape(-1, 2),
             color, width, alpha)


def fill_polygon(img: np.ndarray, outline, color, alpha: float = 1.0) -> None:
    """Fill the polygon `outline` ((N, 2) xy) by the even-odd rule over
    pixel centers."""
    v = np.asarray(outline, np.float64).reshape(-1, 2)
    h, w = img.shape[:2]
    x0, y0 = np.maximum(np.floor(v.min(0)), 0).astype(int)
    x1 = int(min(np.ceil(v[:, 0].max()), w - 1))
    y1 = int(min(np.ceil(v[:, 1].max()), h - 1))
    if x1 < x0 or y1 < y0:
        return
    ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1].astype(np.float64)
    inside = np.zeros(ys.shape, bool)
    a, b = v, np.roll(v, -1, axis=0)
    for (ax, ay), (bx, by) in zip(a, b):
        cross = (ay > ys) != (by > ys)
        with np.errstate(divide='ignore', invalid='ignore'):
            xint = ax + (ys - ay) * (bx - ax) / (by - ay)
        inside ^= cross & (xs < xint)
    blend(img, ys[inside], xs[inside], color, alpha)


def fill_wedges(img: np.ndarray, centers, radii, theta1, theta2, color,
                alpha: float = 1.0) -> None:
    """Filled circular sectors: centers (M, 2) xy, radii (M,), angles in
    degrees counter-clockwise from +x in image coordinates (y down)."""
    c = np.asarray(centers, np.float64).reshape(-1, 2)
    r = np.broadcast_to(np.asarray(radii, np.float64), (len(c),))
    t1 = np.broadcast_to(np.asarray(theta1, np.float64), (len(c),))
    t2 = np.broadcast_to(np.asarray(theta2, np.float64), (len(c),))
    for (cx, cy), rr, a1, a2 in zip(c, r, t1, t2):
        if not (np.isfinite(rr) and rr > 0 and np.isfinite([cx, cy]).all()):
            continue
        ri = int(np.ceil(rr))
        dy, dx = np.mgrid[-ri:ri + 1, -ri:ri + 1].astype(np.float64)
        ys, xs = np.rint(cy) + dy, np.rint(cx) + dx
        ang = np.degrees(np.arctan2(ys - cy, xs - cx)) % 360.0
        lo, hi = a1 % 360.0, a2 % 360.0 if a2 % 360.0 else 360.0
        sector = (ang >= lo) & (ang <= hi) if lo <= hi else \
            (ang >= lo) | (ang <= hi)
        keep = ((ys - cy) ** 2 + (xs - cx) ** 2 <= rr * rr) & sector
        blend(img, ys[keep], xs[keep], color, alpha)


_GLYPHS = {                              # 3x5 bitmaps, rows top to bottom
    '0': ('111', '101', '101', '101', '111'),
    '1': ('010', '110', '010', '010', '111'),
    '2': ('111', '001', '111', '100', '111'),
    '3': ('111', '001', '111', '001', '111'),
    '4': ('101', '101', '111', '001', '001'),
    '5': ('111', '100', '111', '001', '111'),
    '6': ('111', '100', '111', '101', '111'),
    '7': ('111', '001', '010', '010', '010'),
    '8': ('111', '101', '111', '101', '111'),
    '9': ('111', '101', '111', '001', '111'),
    '.': ('000', '000', '000', '000', '010'),
    '-': ('000', '000', '111', '000', '000'),
}


def text(img: np.ndarray, x: float, y: float, s: str, color,
         scale: int = 2) -> None:
    """Write `s` (digits, `.` and `-`) with its top-left corner at (x, y),
    each glyph 3x5 cells of `scale` pixels, one cell apart."""
    x0, y0 = int(np.rint(x)), int(np.rint(y))
    ys, xs = [], []
    for i, ch in enumerate(s):
        rows = _GLYPHS.get(ch)
        if rows is None:
            raise ValueError(f'no glyph for {ch!r}')
        for r, bits in enumerate(rows):
            for c, bit in enumerate(bits):
                if bit == '1':
                    cy, cx = np.mgrid[0:scale, 0:scale]
                    ys.append(y0 + r * scale + cy.ravel())
                    xs.append(x0 + (4 * i + c) * scale + cx.ravel())
    if ys:
        blend(img, np.concatenate(ys), np.concatenate(xs), color)
