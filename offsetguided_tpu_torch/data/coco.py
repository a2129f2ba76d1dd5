"""COCO keypoint annotation index, mask rendering and image reading,
without pycocotools.

`CocoJson` is the JAX package's index (image listing and filtering,
per-image annotations, image info). The masks are its RLE decoding and
polygon rasterization; the JAX package fills polygons with `cv2.fillPoly`,
which `polygons_to_mask` repeats in numpy, pixel for pixel (outline and
even-odd scanline fill), so it runs where OpenCV is not installed.

`read_image` gives what the JAX package's `cv2.imread` + BGR2RGB gives:
JPEG and PNG files go through the port's own codec (`data/codec.py`, no
OpenCV), and a `.npy` file is read with numpy (uint8 RGB, as written).
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from . import codec


def rle_decode_counts(s: str) -> List[int]:
    """Decode a COCO compressed RLE counts string (LEB128-style, 5-bit words
    with continuation and sign bits) into run lengths."""
    counts: List[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_to_mask(rle: Dict) -> np.ndarray:
    """COCO RLE dict {'size': [h, w], 'counts': str|list} -> uint8 mask."""
    h, w = rle['size']
    counts = rle['counts']
    if isinstance(counts, str):
        counts = rle_decode_counts(counts)
    flat = np.zeros(h * w, dtype=np.uint8)
    pos = 0
    val = 0
    for run in counts:
        if val:
            flat[pos:pos + run] = 1
        pos += run
        val ^= 1
    # COCO RLE is column-major
    return flat.reshape(w, h).T


# --- cv2.fillPoly (8-connected outline + even-odd scanline fill) ----------- #

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _tdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(w: int, h: int, x1, y1, x2, y2):
    """OpenCV's clipLine to [0, w-1] x [0, h-1]: (inside, x1, y1, x2, y2)."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line8(mask: np.ndarray, x1, y1, x2, y2) -> None:
    """OpenCV's 8-connected Bresenham line (LineIterator, left to right)."""
    h, w = mask.shape
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
        sx, sy = sy, sx
    err = dx - 2 * dy
    # minor steps (plus) along y, or along x for a steep line
    x, y = x1, y1
    for _ in range(dx + 1):
        mask[y, x] = 1
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y += sx
            x += sy if minor else 0
        else:
            x += sx
            y += sy if minor else 0


class _Edge:
    __slots__ = ('y0', 'y1', 'x', 'dx', 'next')

    def __init__(self, y0=0, y1=0, x=0, dx=0):
        self.y0, self.y1, self.x, self.dx, self.next = y0, y1, x, dx, None


def _collect_edges(mask: np.ndarray, pts: np.ndarray, edges: list) -> None:
    """OpenCV's CollectPolyEdges (shift 0, 8-connected): draws each edge's
    outline and collects the non-horizontal ones in 16.16 fixed point."""
    h, w = mask.shape
    n = len(pts)
    p0x, p0y = int(pts[-1, 0]) << _XY_SHIFT, int(pts[-1, 1])
    for i in range(n):
        p1x, p1y = int(pts[i, 0]) << _XY_SHIFT, int(pts[i, 1])
        c0x, c0y, c1x, c1y = p0x, p0y, p1x, p1y
        t0x = (p0x + (_XY_ONE >> 1)) >> _XY_SHIFT
        t1x = (p1x + (_XY_ONE >> 1)) >> _XY_SHIFT
        t0y, t1y = p0y, p1y
        _line8(mask, t0x, t0y, t1x, t1y)
        if not (0 <= t0x < w and 0 <= t1x < w and 0 <= t0y < h
                and 0 <= t1y < h):
            # an edge leaving the image runs between its clipped x's, over
            # its clipped rows where those differ, else its own rows
            _, t0x, t0y, t1x, t1y = _clip_line(w, h, t0x, t0y, t1x, t1y)
            c0x, c1x = t0x << _XY_SHIFT, t1x << _XY_SHIFT
            if t0y != t1y:
                c0y, c1y = t0y, t1y
        if p0y != p1y:
            dx = _tdiv(c1x - c0x, c1y - c0y)
            if p0y < p1y:
                edges.append(_Edge(p0y, p1y, c0x + (p0y - c0y) * dx, dx))
            else:
                edges.append(_Edge(p1y, p0y, c1x + (p1y - c1y) * dx, dx))
        p0x, p0y = p1x, p1y


def _fill_edges(mask: np.ndarray, edges: list) -> None:
    """OpenCV's FillEdgeCollection: even-odd scanline fill over the active
    edge list, spans inclusive."""
    h, w = mask.shape
    total = len(edges)
    if total < 2:
        return
    y_min = min(e.y0 for e in edges)
    y_max = max(e.y1 for e in edges)
    xs = [e.x for e in edges] + [e.x + (e.y1 - e.y0) * e.dx for e in edges]
    if y_max < 0 or y_min >= h or max(xs) < 0 or min(xs) >= (w << _XY_SHIFT):
        return
    edges.sort(key=lambda e: (e.y0, e.x, e.dx))
    sentinel = _Edge(y0=2 ** 62)
    edges.append(sentinel)
    head = _Edge()                      # `tmp`: the active list's head
    i = 0
    e = edges[0]
    y_max = min(y_max, h)
    y = e.y0
    while y < y_max:
        draw = False
        clipline = y < 0
        prelast, last = head, head.next
        while last is not None or e.y0 == y:
            if last is not None and last.y1 == y:
                prelast.next = last.next   # the edge ends: drop it
                last = last.next
                continue
            keep_prelast = prelast
            if last is not None and (e.y0 > y or last.x < e.x):
                prelast, last = last, last.next
            elif i < total:
                prelast.next = e           # the edge starts: insert it
                e.next = last
                prelast = e
                i += 1
                e = edges[i]
            else:
                break
            if draw:
                if not clipline:
                    # the pixels whose centers lie in [left, right]
                    lo, hi = sorted((keep_prelast.x, prelast.x))
                    x1 = (lo + _XY_ONE - 1) >> _XY_SHIFT
                    x2 = hi >> _XY_SHIFT
                    if x1 < w and x2 >= 0:
                        mask[y, max(x1, 0):min(x2, w - 1) + 1] = 1
                keep_prelast.x += keep_prelast.dx
                prelast.x += prelast.dx
            draw = not draw
        # OpenCV re-sorts the active list by x with a bubble sort: stable
        active = []
        last = head.next
        while last is not None:
            active.append(last)
            last = last.next
        active.sort(key=lambda a: a.x)
        prelast = head
        for a in active:
            prelast.next = a
            prelast = a
        prelast.next = None
        y += 1


def polygons_to_mask(polys: List[List[float]], h: int, w: int) -> np.ndarray:
    """Rasterize a polygon segmentation to a uint8 {0, 1} mask: the pixel
    set of `cv2.fillPoly(mask, parts, 1)` (vertices rounded half to even;
    every part's 8-connected outline, then one even-odd fill over all
    parts' edges)."""
    mask = np.zeros((h, w), dtype=np.uint8)
    pts = [np.round(np.asarray(p, dtype=np.float64).reshape(-1, 2))
           .astype(np.int32) for p in polys if len(p) >= 6]
    edges: list = []
    for p in pts:
        _collect_edges(mask, p, edges)
    _fill_edges(mask, edges)
    return mask


def ann_to_mask(ann: Dict, h: int, w: int) -> np.ndarray:
    """Segmentation of one annotation -> uint8 {0,1} mask
    (pycocotools annToMask equivalent)."""
    seg = ann.get('segmentation')
    if seg is None:
        return np.zeros((h, w), dtype=np.uint8)
    if isinstance(seg, dict):
        return rle_to_mask(seg)
    return polygons_to_mask(seg, h, w)


def build_miss_masks(anns: List[Dict], h: int, w: int):
    """(mask_miss, mask_all) uint8 masks in 0/255: mask_miss zeroes crowd
    regions and persons without keypoint annotations (or area <= 32^2);
    mask_all covers every person segment."""
    mask_all = np.zeros((h, w), dtype=np.uint8)
    mask_miss = np.zeros((h, w), dtype=np.uint8)
    mask_crowd: Optional[np.ndarray] = None
    for ann in anns:
        m = ann_to_mask(ann, h, w)
        if ann.get('iscrowd'):
            overlap = np.bitwise_and(mask_all, m)
            add = m - overlap
            mask_crowd = add if mask_crowd is None else \
                np.bitwise_or(mask_crowd, add)
            continue
        mask_all = np.bitwise_or(mask_all, m)
        if ann.get('num_keypoints', 0) <= 0 or ann.get('area', 0) <= 32 * 32:
            mask_miss = np.bitwise_or(mask_miss, m)
    if mask_crowd is None:
        mask_miss = np.logical_not(mask_miss)
    else:
        mask_miss = np.logical_not(np.bitwise_or(mask_miss, mask_crowd))
        mask_all = np.bitwise_or(mask_all, mask_crowd)
    return (mask_miss.astype(np.uint8) * 255, mask_all.astype(np.uint8) * 255)


class CocoJson:
    """Minimal COCO annotation index (person keypoints)."""

    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            d = json.load(f)
        self.dataset = d
        self.imgs = {im['id']: im for im in d.get('images', [])}
        self.cats = {c['id']: c for c in d.get('categories', [])}
        self.person_cat_ids = [c['id'] for c in d.get('categories', [])
                               if c.get('name') == 'person'] or [1]
        self.img_to_anns = defaultdict(list)
        for ann in d.get('annotations', []):
            if ann.get('category_id') in self.person_cat_ids:
                self.img_to_anns[ann['image_id']].append(ann)

    def image_ids(self, with_persons: bool = False,
                  with_keypoints: bool = False) -> List[int]:
        ids = list(self.imgs.keys())
        if with_persons or with_keypoints:
            ids = [i for i in ids if self.img_to_anns.get(i)]
        if with_keypoints:
            def has_kp(i):
                return any(any(v > 0 for v in a.get('keypoints', [])[2::3])
                           for a in self.img_to_anns[i])
            ids = [i for i in ids if has_kp(i)]
        return sorted(ids)

    def anns_for_image(self, image_id: int) -> List[Dict]:
        return self.img_to_anns.get(image_id, [])

    def image_info(self, image_id: int) -> Dict:
        return self.imgs[image_id]


def read_image(path: str) -> Optional[np.ndarray]:
    """(H, W, 3) uint8 RGB, or None when the file is missing or unreadable:
    `.npy` files hold uint8 RGB already; JPEG and PNG go through the
    codec."""
    if not path.endswith('.npy'):
        return codec.imread(path)
    try:
        img = np.load(path)
    except (OSError, ValueError):
        return None
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f'{path}: expected (H, W, 3) uint8 RGB, got '
                         f'{img.dtype} {img.shape}')
    return img
