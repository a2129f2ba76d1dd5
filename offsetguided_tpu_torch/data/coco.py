"""COCO keypoint annotation index and image reading, without pycocotools.

`CocoJson` is the JAX package's index (image listing and filtering,
per-image annotations, image info); RLE and mask rendering come with the
training slice.

`read_image` is the one IO difference from the JAX package, which reads
every image with cv2: a `.npy` file is read with numpy (uint8 RGB, as
written), so evaluation runs where no image codec is installed; any other
file goes through cv2, imported at the call.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np


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
    """(H, W, 3) uint8 RGB, or None when the file is missing or unreadable.
    `.npy` files hold uint8 RGB already; other formats need OpenCV."""
    if path.endswith('.npy'):
        try:
            img = np.load(path)
        except (OSError, ValueError):
            return None
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f'{path}: expected (H, W, 3) uint8 RGB, got '
                             f'{img.dtype} {img.shape}')
        return img
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f'reading {path} needs OpenCV (cv2), which is not installed; '
            f'store the images as (H, W, 3) uint8 RGB .npy files instead'
        ) from e
    img = cv2.imread(path)
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
