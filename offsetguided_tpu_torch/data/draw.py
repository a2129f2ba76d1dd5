"""cv2's drawing in its 16-bit fixed point, in numpy, for the port's
synthetic images (the self-check's stick figures, the painted hard set):
filled circles (the same pixels as cv2.circle) and 3-pixel lines (a
filled quadrilateral with round caps, as cv2.line draws them; its edge
rasterization rounds differently from cv2's, so about one line in twelve
gets two pixels more). Colours are written as given, into (H, W, 3)
uint8 arrays, in place.
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
