"""Two answers compared keypoint by keypoint.

An answer (a served request's poses, or one image's COCO records) is a
set of keypoints of each joint type in pixels. A keypoint of one
side is matched where the other side has a keypoint of the same joint
within `tol_px` pixels. An answer's mismatch is the share of the two
sides' keypoints left unmatched; it is 0 where both are empty and 1 where
one side is.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def from_poses(poses: np.ndarray) -> List[np.ndarray]:
    """(M, J, >=3) poses -> per joint the (n, 2) positions of the
    keypoints with a positive score."""
    poses = np.asarray(poses, np.float64)
    return [poses[poses[:, j, 2] > 0, j, :2] for j in range(poses.shape[1])]


def rows_of(recs: Sequence[Dict]) -> np.ndarray:
    """COCO keypoint records of one image -> their keypoint lists as one
    (n, 3 J) array."""
    return np.asarray([r['keypoints'] for r in recs], np.float64)


def from_records(recs, n_keypoints: int) -> List[np.ndarray]:
    """COCO keypoint records of one image (or their `rows_of` array) ->
    per joint the (n, 2) positions flagged present."""
    a = rows_of(recs) if not isinstance(recs, np.ndarray) else recs
    if not len(a):
        return [np.zeros((0, 2)) for _ in range(n_keypoints)]
    a = a.reshape(len(a), n_keypoints, 3)
    return [a[a[:, j, 2] > 0, j, :2] for j in range(n_keypoints)]


def _unmatched(a: np.ndarray, b: np.ndarray, tol: float) -> int:
    if len(a) == 0:
        return 0
    if len(b) == 0:
        return len(a)
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return int((d2.min(axis=1) > tol * tol).sum())


def mismatch(a: List[np.ndarray], b: List[np.ndarray], tol: float) -> float:
    """Share of the keypoints of `a` and `b` (per-joint position lists)
    without a partner of the same joint within `tol` pixels."""
    n = sum(len(x) for x in a) + sum(len(x) for x in b)
    if n == 0:
        return 0.0
    miss = sum(_unmatched(x, y, tol) + _unmatched(y, x, tol)
               for x, y in zip(a, b))
    return miss / n


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> list:
    """[(name, value, limit)] for every limited number; a number the run
    could not produce reads as infinite."""
    return [(name, numbers.get(name, float('inf')), limit)
            for name, limit in limits.items()]
