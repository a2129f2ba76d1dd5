"""Hard synthetic COCO-style keypoint benchmark.

A copy of the JAX package's `data/synthetic.py::make_hard_dataset`, drawing
the same random stream, so a seed gives the same scenes and the same
annotations: COCO-like scale statistics, overlapping pairs, border-truncated
people, occlusion-marked keypoints and crowd regions. Feeding its GT through
encode -> decode (`cli/simulate.py`) measures the AP ceiling of the
encoding under realistic difficulty.

`hard_annotations` builds the COCO annotation dict; `make_hard_dataset`
also writes the images, as `.npy` (uint8 RGB, unpainted) or as JPEG / PNG
through the port's codec (`data/codec.py`), with the figures painted as
the JAX version paints them. The annotations are the JAX package's; the
painted pixels are not its pixels: the limbs are the numpy 3-pixel lines
of `data/draw.py` (cv2.line at thickness 2 in the JAX package), the
joints the same filled circles, and the JPEG is the codec's.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..config import COCO_KEYPOINTS, COCO_PERSON_SKELETON
from . import codec
from .draw import circle, line3

# upright stick figure in a 1x1 box (x, y), COCO keypoint order
TEMPLATE = np.array([
    [0.50, 0.07], [0.46, 0.05], [0.54, 0.05], [0.42, 0.07], [0.58, 0.07],
    [0.36, 0.22], [0.64, 0.22], [0.32, 0.40], [0.68, 0.40], [0.30, 0.57],
    [0.70, 0.57], [0.41, 0.54], [0.59, 0.54], [0.40, 0.75], [0.60, 0.75],
    [0.39, 0.95], [0.61, 0.95]], dtype=np.float32)

# limb pairs used only for painting the figures into the image pixels
DRAW_LIMBS = ((5, 7), (7, 9), (6, 8), (8, 10), (5, 6), (11, 12), (5, 11),
              (6, 12), (11, 13), (13, 15), (12, 14), (14, 16), (0, 5), (0, 6))

SIZES = ((480, 640), (640, 480), (640, 640), (427, 640), (640, 427))


def _make_person(rng, h, w, box):
    """One (17, 3) person at a random position; may be border-truncated."""
    kps = TEMPLATE.copy()
    if rng.rand() < 0.5:
        kps[:, 0] = 1.0 - kps[:, 0]
    sx = box * (0.75 + 0.5 * rng.rand())
    sy = box * (0.85 + 0.3 * rng.rand())
    ang = (rng.rand() - 0.5) * 0.6            # up to ~17 degrees
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
    # v=2 visible, v=1 labeled-but-occluded (random 15%), v=0 outside image
    v = np.where(rng.rand(17) < 0.15, 1, 2).astype(np.float32)
    out[:, 2] = np.where(inside, v, 0.0)
    out[~inside, :2] = 0.0
    return out


def paint_figures(img, kps):
    """The JAX package's figure painting (its colours, in cv2's BGR
    order) with the numpy primitives."""
    pts = kps[:, :2].astype(int)
    for a, b in DRAW_LIMBS:
        if kps[a, 2] > 0 and kps[b, 2] > 0:
            line3(img, pts[a], pts[b], (210, 60, 60))
    for j in range(17):
        if kps[j, 2] > 0:
            circle(img, pts[j, 0], pts[j, 1], 3, (60, 200, 60))
    return img


def _box_record(ann_id, img_id, bx, by, bw, bh, **fields) -> Dict:
    return dict({'id': ann_id, 'image_id': img_id, 'category_id': 1,
                 'bbox': [float(bx), float(by), float(bw), float(bh)],
                 'segmentation': [[float(bx), float(by), float(bx + bw),
                                   float(by), float(bx + bw), float(by + bh),
                                   float(bx), float(by + bh)]]}, **fields)


def hard_annotations(n_images: int = 100, seed: int = 0, ext: str = 'jpg',
                     on_image: Optional[Callable] = None) -> Dict:
    """The benchmark's COCO annotation dict (images `{id:06d}.{ext}`).
    `on_image(img_id, pixels, persons)` receives each image's uint8 pixels
    and its annotated (17, 3) persons."""
    rng = np.random.RandomState(seed)
    images, annotations = [], []
    ann_id = 1
    for img_id in range(1, n_images + 1):
        h, w = SIZES[rng.randint(len(SIZES))]
        # drawn whether or not the caller wants pixels: it is in the stream
        img = (rng.rand(h, w, 3) * 60 + 70).astype(np.uint8)
        persons: List[np.ndarray] = []
        n_base = 1 + rng.randint(8)
        for _ in range(n_base):
            # log-uniform scale over the COCO-relevant range
            box = float(np.exp(rng.uniform(np.log(36.0), np.log(440.0))))
            box = min(box, 1.1 * min(h, w))
            kps = _make_person(rng, h, w, box)
            persons.append(kps)
            # overlapping partner at a similar scale
            if rng.rand() < 0.35 and len(persons) < 14:
                partner = kps.copy()
                ok = partner[:, 2] > 0
                dx = box * rng.uniform(0.2, 0.5) * rng.choice([-1, 1])
                dy = box * rng.uniform(-0.2, 0.2)
                partner[ok, 0] += dx
                partner[ok, 1] += dy
                inside = ((partner[:, 0] >= 0) & (partner[:, 0] <= w - 1)
                          & (partner[:, 1] >= 0) & (partner[:, 1] <= h - 1)
                          & ok)
                partner[:, 2] = np.where(inside, partner[:, 2], 0.0)
                partner[~inside, :2] = 0.0
                persons.append(partner)

        kept = []
        for kps in persons:
            n_vis = int((kps[:, 2] > 0).sum())
            if n_vis < 3:
                continue
            pos = kps[kps[:, 2] > 0]
            bx, by = pos[:, 0].min() - 3, pos[:, 1].min() - 3
            bw = pos[:, 0].max() - pos[:, 0].min() + 6
            bh = pos[:, 1].max() - pos[:, 1].min() + 6
            annotations.append(_box_record(
                ann_id, img_id, bx, by, bw, bh,
                keypoints=kps.reshape(-1).tolist(), num_keypoints=n_vis,
                iscrowd=0, area=float(bw * bh * 0.55)))
            ann_id += 1
            kept.append(kps)

        # unannotated crowd region (evaluators treat iscrowd GT as
        # non-scoring)
        if rng.rand() < 0.25:
            cw, ch = rng.uniform(60, 200), rng.uniform(60, 200)
            cx = rng.uniform(0, max(w - cw, 1))
            cy = rng.uniform(0, max(h - ch, 1))
            annotations.append(_box_record(
                ann_id, img_id, cx, cy, cw, ch, keypoints=[0.0] * 51,
                num_keypoints=0, iscrowd=1, area=float(cw * ch)))
            ann_id += 1

        if on_image is not None:
            on_image(img_id, img, kept)
        images.append({'id': img_id, 'file_name': f'{img_id:06d}.{ext}',
                       'height': int(h), 'width': int(w)})

    # standard COCO category record (keypoint names + 1-based skeleton)
    return {'images': images, 'annotations': annotations,
            'categories': [{
                'id': 1, 'name': 'person', 'keypoints': list(COCO_KEYPOINTS),
                'skeleton': [[a + 1, b + 1]
                             for a, b in COCO_PERSON_SKELETON]}]}


def write_annotations(root: str, dataset: Dict) -> str:
    os.makedirs(root, exist_ok=True)
    ann_file = os.path.join(root, 'annotations.json')
    with open(ann_file, 'w') as f:
        json.dump(dataset, f)
    return ann_file


def make_hard_dataset(root: str, n_images: int = 100, seed: int = 0,
                      paint: bool = True, ext: str = 'jpg'
                      ) -> Tuple[str, str]:
    """Write the benchmark's images and annotations under `root`; returns
    (image_dir, annotation_file). `ext='npy'` stores the unpainted uint8
    RGB arrays; `'jpg'` (quality 95, 4:2:0) and `'png'` go through the
    codec, painted unless `paint` is False. The arrays are in cv2's BGR
    order, as in the JAX package, so the RGB written is their reverse."""
    img_dir = os.path.join(root, 'images')
    os.makedirs(img_dir, exist_ok=True)

    def save(img_id, img, persons):
        path = os.path.join(img_dir, f'{img_id:06d}.{ext}')
        if ext == 'npy':
            np.save(path, img)
            return
        if paint:
            for kps in persons:
                paint_figures(img, kps)
        codec.imwrite(path, img[:, :, ::-1])

    ds = hard_annotations(n_images, seed, ext, on_image=save)
    return img_dir, write_annotations(root, ds)
