"""The benchmark's scenes: painted people on a noisy background.

A copy of the hard set's person generator (the port's
`data/synthetic.py::_make_person`, the JAX package's stick figure with its
scale, flip, tilt and truncation statistics), painted with plain numpy
discs and 2-pixel-radius segments in the generator's colours. Everything
a traffic file asks for comes from here, from one seed: the same seed
gives the same scenes, and every seed gives the same list of sizes in
another order, so the work of a run does not depend on the seed.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# upright stick figure in a 1x1 box (x, y), COCO keypoint order
TEMPLATE = np.array([
    [0.50, 0.07], [0.46, 0.05], [0.54, 0.05], [0.42, 0.07], [0.58, 0.07],
    [0.36, 0.22], [0.64, 0.22], [0.32, 0.40], [0.68, 0.40], [0.30, 0.57],
    [0.70, 0.57], [0.41, 0.54], [0.59, 0.54], [0.40, 0.75], [0.60, 0.75],
    [0.39, 0.95], [0.61, 0.95]], dtype=np.float32)
DRAW_LIMBS = ((5, 7), (7, 9), (6, 8), (8, 10), (5, 6), (11, 12), (5, 11),
              (6, 12), (11, 13), (13, 15), (12, 14), (14, 16), (0, 5), (0, 6))
LIMB_RGB = (60, 60, 210)
JOINT_RGB = (60, 200, 60)


def rng_for(seed: int, tag: int) -> np.random.RandomState:
    """A numpy stream for (seed, tag); any whole-number seed."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), tag])
    return np.random.RandomState(ss.generate_state(1)[0])


def make_person(rng, h: int, w: int, box: float) -> np.ndarray:
    """One (17, 3) person at a random position; may be border-truncated."""
    kps = TEMPLATE.copy()
    if rng.rand() < 0.5:
        kps[:, 0] = 1.0 - kps[:, 0]
    sx = box * (0.75 + 0.5 * rng.rand())
    sy = box * (0.85 + 0.3 * rng.rand())
    ang = (rng.rand() - 0.5) * 0.6
    ca, sa = np.cos(ang), np.sin(ang)
    x = (kps[:, 0] - 0.5) * sx
    y = (kps[:, 1] - 0.5) * sy
    rx, ry = ca * x - sa * y, sa * x + ca * y
    cx = rng.uniform(-0.15 * box, w - 1 + 0.15 * box)
    cy = rng.uniform(-0.15 * box, h - 1 + 0.15 * box)
    out = np.zeros((17, 3), np.float32)
    out[:, 0] = cx + rx + rng.randn(17) * box * 0.012
    out[:, 1] = cy + ry + rng.randn(17) * box * 0.012
    inside = ((out[:, 0] >= 0) & (out[:, 0] <= w - 1)
              & (out[:, 1] >= 0) & (out[:, 1] <= h - 1))
    v = np.where(rng.rand(17) < 0.15, 1, 2).astype(np.float32)
    out[:, 2] = np.where(inside, v, 0.0)
    out[~inside, :2] = 0.0
    return out


def _segment(img, p, q, radius, color):
    h, w = img.shape[:2]
    x0 = int(max(min(p[0], q[0]) - radius, 0))
    x1 = int(min(max(p[0], q[0]) + radius + 1, w))
    y0 = int(max(min(p[1], q[1]) - radius, 0))
    y1 = int(min(max(p[1], q[1]) + radius + 1, h))
    if x0 >= x1 or y0 >= y1:
        return
    ys, xs = np.mgrid[y0:y1, x0:x1]
    d = np.asarray(q, np.float64) - np.asarray(p, np.float64)
    t = ((xs - p[0]) * d[0] + (ys - p[1]) * d[1]) / max(d @ d, 1e-9)
    t = np.clip(t, 0.0, 1.0)
    dx, dy = xs - (p[0] + t * d[0]), ys - (p[1] + t * d[1])
    img[y0:y1, x0:x1][dx * dx + dy * dy <= radius * radius] = color


def paint(img: np.ndarray, kps: np.ndarray) -> None:
    """Limbs as 2-pixel-radius segments, joints as discs of radius 3."""
    pts = kps[:, :2].astype(int)
    for a, b in DRAW_LIMBS:
        if kps[a, 2] > 0 and kps[b, 2] > 0:
            _segment(img, pts[a], pts[b], 2, LIMB_RGB)
    for j in range(17):
        if kps[j, 2] > 0:
            _segment(img, pts[j], pts[j], 3, JOINT_RGB)


def scene(rng, h: int, w: int) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(h, w, 3) uint8 RGB scene and its (17, 3) persons: 1-8 people at
    log-uniform sizes of 36-440 px, a third with an overlapping partner."""
    img = (rng.rand(h, w, 3) * 60 + 70).astype(np.uint8)
    persons = []
    for _ in range(1 + rng.randint(8)):
        box = float(np.exp(rng.uniform(np.log(36.0), np.log(440.0))))
        box = min(box, 1.1 * min(h, w))
        kps = make_person(rng, h, w, box)
        persons.append(kps)
        if rng.rand() < 0.35 and len(persons) < 14:
            partner = kps.copy()
            ok = partner[:, 2] > 0
            partner[ok, 0] += box * rng.uniform(0.2, 0.5) * rng.choice([-1, 1])
            partner[ok, 1] += box * rng.uniform(-0.2, 0.2)
            inside = ((partner[:, 0] >= 0) & (partner[:, 0] <= w - 1)
                      & (partner[:, 1] >= 0) & (partner[:, 1] <= h - 1) & ok)
            partner[:, 2] = np.where(inside, partner[:, 2], 0.0)
            partner[~inside, :2] = 0.0
            persons.append(partner)
    kept = [p for p in persons if (p[:, 2] > 0).sum() >= 3]
    for kps in kept:
        paint(img, kps)
    return img, kept


def scene_sizes(sizes: Sequence[Sequence[int]], n: int, rng) -> List[tuple]:
    """`n` (h, w) sizes: the traffic's list repeated in turn, shuffled."""
    out = [tuple(sizes[i % len(sizes)]) for i in range(n)]
    order = rng.permutation(n)
    return [out[i] for i in order]


def make_scenes(traffic: dict, seed: int):
    """The traffic's `n_scenes` scenes of its `sizes`: [(img, persons)]."""
    rng = rng_for(seed, 1)
    return [scene(rng, h, w)
            for h, w in scene_sizes(traffic['sizes'], traffic['n_scenes'],
                                    rng)]

