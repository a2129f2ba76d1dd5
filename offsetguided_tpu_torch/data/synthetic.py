"""Synthetic COCO-style keypoint benchmarks: the hard set and the crowd set.

Copies of the JAX package's `data/synthetic.py::make_hard_dataset` and
`make_crowd_dataset`, drawing the same random stream, so a seed gives the
same scenes and the same annotations, written to the same JSON bytes.
The hard set has COCO-like scale statistics, overlapping pairs,
border-truncated people, occlusion-marked keypoints and crowd regions;
feeding its GT through encode -> decode (`cli/simulate.py`) measures the
AP ceiling of the encoding under realistic difficulty. The crowd set is
the stress test of the decoder's fixed capacities: 640x640 scenes of
50-70 people each at 40-150 px, heavily overlapping.

`hard_annotations` / `crowd_annotations` build the COCO annotation dict;
`make_hard_dataset` / `make_crowd_dataset` also write the images, as
`.npy` (uint8, unpainted) or as JPEG / PNG through the port's codec
(`data/codec.py`), with the figures painted as the JAX version paints
them. The annotations are the JAX package's; the painted pixels are not
its pixels: the limbs are the numpy 3-pixel lines of `data/draw.py`
(cv2.line at thickness 2 in the JAX package), the joints the same filled
circles, and the JPEG is the codec's.

    python -m offsetguided_tpu_torch.data.synthetic OUT [--n-images N]
        [--seed S] [--crowd MIN,MAX]

writes `OUT/images/*.jpg` and `OUT/annotations.json` (the crowd set with
`--crowd`) and prints the two paths, as the JAX generator does.
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


def _record(ann_id, img_id, keypoints, num_keypoints, iscrowd,
            bx, by, bw, bh, area) -> Dict:
    """One COCO annotation, its keys in the JAX generator's order."""
    return {'id': ann_id, 'image_id': img_id, 'category_id': 1,
            'keypoints': keypoints, 'num_keypoints': num_keypoints,
            'iscrowd': iscrowd,
            'bbox': [float(bx), float(by), float(bw), float(bh)],
            'area': area,
            'segmentation': [[float(bx), float(by), float(bx + bw),
                              float(by), float(bx + bw), float(by + bh),
                              float(bx), float(by + bh)]]}


def _person_record(ann_id, img_id, kps) -> Optional[Dict]:
    """The annotation of a (17, 3) person, its box 3 px around the visible
    keypoints; None for a person with fewer than 3 of them."""
    n_vis = int((kps[:, 2] > 0).sum())
    if n_vis < 3:
        return None
    pos = kps[kps[:, 2] > 0]
    bx, by = pos[:, 0].min() - 3, pos[:, 1].min() - 3
    bw = pos[:, 0].max() - pos[:, 0].min() + 6
    bh = pos[:, 1].max() - pos[:, 1].min() + 6
    return _record(ann_id, img_id, kps.reshape(-1).tolist(), n_vis, 0,
                   bx, by, bw, bh, float(bw * bh * 0.55))


def _coco(images: List[Dict], annotations: List[Dict]) -> Dict:
    """The dataset dict with the standard COCO category record (keypoint
    names + 1-based skeleton)."""
    return {'images': images, 'annotations': annotations,
            'categories': [{
                'id': 1, 'name': 'person', 'keypoints': list(COCO_KEYPOINTS),
                'skeleton': [[a + 1, b + 1]
                             for a, b in COCO_PERSON_SKELETON]}]}


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
            rec = _person_record(ann_id, img_id, kps)
            if rec is None:
                continue
            annotations.append(rec)
            ann_id += 1
            kept.append(kps)

        # unannotated crowd region (evaluators treat iscrowd GT as
        # non-scoring)
        if rng.rand() < 0.25:
            cw, ch = rng.uniform(60, 200), rng.uniform(60, 200)
            cx = rng.uniform(0, max(w - cw, 1))
            cy = rng.uniform(0, max(h - ch, 1))
            annotations.append(_record(ann_id, img_id, [0.0] * 51, 0, 1,
                                       cx, cy, cw, ch, float(cw * ch)))
            ann_id += 1

        if on_image is not None:
            on_image(img_id, img, kept)
        images.append({'id': img_id, 'file_name': f'{img_id:06d}.{ext}',
                       'height': int(h), 'width': int(w)})

    return _coco(images, annotations)


def crowd_annotations(n_images: int = 30, seed: int = 0,
                      n_persons: Tuple[int, int] = (50, 70),
                      ext: str = 'jpg',
                      on_image: Optional[Callable] = None) -> Dict:
    """The crowd set's COCO annotation dict: `n_persons` (inclusive range)
    people drawn for each 640x640 image at log-uniform 40-150 px, those
    with fewer than 3 visible keypoints left out. `on_image` as in
    `hard_annotations`."""
    rng = np.random.RandomState(seed)
    images, annotations = [], []
    ann_id = 1
    for img_id in range(1, n_images + 1):
        h = w = 640
        img = (rng.rand(h, w, 3) * 60 + 70).astype(np.uint8)
        kept = []
        for _ in range(rng.randint(n_persons[0], n_persons[1] + 1)):
            box = float(np.exp(rng.uniform(np.log(40.0), np.log(150.0))))
            kps = _make_person(rng, h, w, box)
            rec = _person_record(ann_id, img_id, kps)
            if rec is None:
                continue
            annotations.append(rec)
            ann_id += 1
            kept.append(kps)
        if on_image is not None:
            on_image(img_id, img, kept)
        images.append({'id': img_id, 'file_name': f'{img_id:06d}.{ext}',
                       'height': int(h), 'width': int(w)})
    return _coco(images, annotations)


def write_annotations(root: str, dataset: Dict) -> str:
    os.makedirs(root, exist_ok=True)
    ann_file = os.path.join(root, 'annotations.json')
    with open(ann_file, 'w') as f:
        json.dump(dataset, f)
    return ann_file


def _image_writer(img_dir: str, ext: str, paint: bool) -> Callable:
    """The `on_image` that writes each scene under `img_dir`: `.npy` stores
    the unpainted uint8 array, `.jpg` (quality 95, 4:2:0) and `.png` go
    through the codec, painted unless `paint` is False. The arrays are in
    cv2's BGR order, as in the JAX package, so the RGB written is their
    reverse."""
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
    return save


def make_hard_dataset(root: str, n_images: int = 100, seed: int = 0,
                      paint: bool = True, ext: str = 'jpg'
                      ) -> Tuple[str, str]:
    """Write the benchmark's images and annotations under `root`; returns
    (image_dir, annotation_file). `ext` and `paint` as `_image_writer`
    takes them."""
    img_dir = os.path.join(root, 'images')
    ds = hard_annotations(n_images, seed, ext,
                          on_image=_image_writer(img_dir, ext, paint))
    return img_dir, write_annotations(root, ds)


def make_crowd_dataset(root: str, n_images: int = 30, seed: int = 0,
                       n_persons: Tuple[int, int] = (50, 70),
                       paint: bool = True, ext: str = 'jpg'
                       ) -> Tuple[str, str]:
    """Write the crowd set's images and annotations under `root`; returns
    (image_dir, annotation_file)."""
    img_dir = os.path.join(root, 'images')
    ds = crowd_annotations(n_images, seed, n_persons, ext,
                           on_image=_image_writer(img_dir, ext, paint))
    return img_dir, write_annotations(root, ds)


def main(argv=None) -> Tuple[str, str]:
    """The generator's command line; prints and returns the image directory
    and the annotation file."""
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('out_dir')
    p.add_argument('--n-images', type=int, default=100)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--crowd', default=None,
                   help='MIN,MAX persons per image: generate the crowd '
                        'stress set instead of the hard benchmark')
    a = p.parse_args(argv)
    if a.crowd:
        lo, hi = (int(x) for x in a.crowd.split(','))
        img_dir, ann_file = make_crowd_dataset(a.out_dir, a.n_images, a.seed,
                                               n_persons=(lo, hi))
    else:
        img_dir, ann_file = make_hard_dataset(a.out_dir, a.n_images, a.seed)
    print(img_dir)
    print(ann_file)
    return img_dir, ann_file


if __name__ == '__main__':
    main()
