"""Training dataset + batching on the host, for the device-augmentation route.

The host reads the image, renders the miss mask, samples every
augmentation parameter and pads annotations to a fixed
`(max_persons, J, 4)` array; the warp, the photometric pass, GT encoding
and mask downscaling run batched on the device (`ops/augment.py`,
`ops/encoder.py`). A background thread prefetches batches.

Port of the JAX package's `data/pipeline.py` on its `device_aug` route.
The host route (warping on the host with cv2) and the worker processes
(`num_workers > 0`) are not ported.
"""
from __future__ import annotations

import logging
import os
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from ..config.defaults import AugmentationConfig, SkeletonConfig
from . import transforms as T
from .coco import CocoJson, build_miss_masks, read_image


def _resize_nearest(mask: np.ndarray, target_w: int,
                    target_h: int) -> np.ndarray:
    """cv2.INTER_NEAREST: source index floor(i / (dst / src)), the scale
    inverted in double precision as cv2 does."""
    h, w = mask.shape
    ys = np.floor(np.arange(target_h) * (1.0 / (target_h / h)))
    xs = np.floor(np.arange(target_w) * (1.0 / (target_w / w)))
    ys = np.minimum(ys.astype(np.int64), h - 1)
    xs = np.minimum(xs.astype(np.int64), w - 1)
    return mask[ys[:, None], xs[None, :]]


class CocoKeypoints:
    """COCO keypoint training dataset on the device-augmentation route.

    `get(i, rng)` returns a dict of fixed-shape arrays (`sample_spec`): the
    raw image on a (raw_canvas, raw_canvas, 3) uint8 canvas (top-left
    anchored), its mask_miss (0/255 uint8, 255 outside the image), the
    padded annotations, the host-sampled augmentation parameters, and meta.
    """

    def __init__(self, image_dir: str, ann_file: str, *,
                 skeleton: SkeletonConfig = SkeletonConfig(),
                 aug: Optional[AugmentationConfig] = AugmentationConfig(),
                 square_length: int = 512, max_persons: int = 32,
                 n_images: Optional[int] = None, all_persons: bool = False,
                 device_aug: bool = False, raw_canvas: int = 640):
        if device_aug and aug is None:
            raise ValueError('device_aug requires an AugmentationConfig')
        self.coco = CocoJson(ann_file)
        self.image_dir = image_dir
        self.skeleton = skeleton
        self.aug = aug
        self.square = square_length
        self.max_persons = max_persons
        self.device_aug = device_aug
        self.raw_canvas = raw_canvas
        self.left_index = [i for i, n in enumerate(skeleton.keypoints)
                           if n.startswith('left')]
        self.right_index = [i for i, n in enumerate(skeleton.keypoints)
                            if n.startswith('right')]
        self.ids = self.coco.image_ids(with_persons=True,
                                       with_keypoints=not all_persons)
        if n_images:
            self.ids = self.ids[:n_images]
        self._warned_canvas = False

    def __len__(self):
        return len(self.ids)

    def _pad_persons(self, anns: np.ndarray) -> np.ndarray:
        J = self.skeleton.n_keypoints
        out = np.zeros((self.max_persons, J, 4), dtype=np.float32)
        p = min(len(anns), self.max_persons)
        out[:p] = anns[:p]
        return out

    def sample_spec(self) -> Dict:
        """Per-sample array layout: key -> (shape, dtype)."""
        J = self.skeleton.n_keypoints
        S = self.raw_canvas
        return {
            'image': ((S, S, 3), np.uint8),
            'mask_miss': ((S, S), np.uint8),
            'anns': ((self.max_persons, J, 4), np.float32),
            'aug_mat': ((3, 3), np.float32),       # src->dst forward
            'aug_mat_inv': ((2, 3), np.float32),   # dst->src (sampling)
            'aug_scale_xy': ((2,), np.float32),
            'aug_flags': ((2,), np.float32),       # [flip, gray]
            'aug_tint': ((4,), np.float32),        # [on, dh, ds, dv]
            'valid_hw': ((2,), np.int32),
        }

    def _get_device_aug(self, image, anns, meta, mask_miss,
                        rng: np.random.RandomState) -> Dict:
        """Raw sample + host-sampled augmentation parameters."""
        aug = self.aug
        if rng.rand() < aug.annotation_jitter_prob:
            anns = T.annotation_jitter(anns, rng)
        params = T.sample_affine_params(aug, rng)
        gray = rng.rand() < aug.gray_prob
        if rng.rand() < aug.color_tint_prob:
            tint = np.array([1.0, rng.randint(-10, 11), rng.randint(-40, 41),
                             rng.randint(-30, 31)], np.float32)
        else:
            tint = np.zeros(4, np.float32)

        C0 = self.raw_canvas
        h, w = image.shape[:2]
        if max(h, w) > C0:                       # rare: source exceeds canvas
            # resampled twice (here and in the warp): warn once, so a wrong
            # --raw-canvas for a dataset shows
            if not self._warned_canvas:
                self._warned_canvas = True
                logging.getLogger(__name__).warning(
                    'device_aug: source image %dx%d exceeds raw_canvas=%d; '
                    'pre-downscaling on the host (raise --raw-canvas to '
                    'cover the largest source side)', w, h, C0)
            image, anns, meta = T.rescale_long_absolute(image, anns, meta, C0)
            mask_miss = _resize_nearest(mask_miss, image.shape[1],
                                        image.shape[0])
            h, w = image.shape[:2]

        roi_center = T._roi_center(anns, meta)
        mat, sx, sy = T.build_affine_mat(params, roi_center,
                                         meta['width_height'],
                                         [self.square, self.square])
        raw = np.zeros((C0, C0, 3), np.uint8)
        raw[:h, :w] = image
        raw_mask = np.full((C0, C0), 255, np.uint8)
        raw_mask[:h, :w] = mask_miss

        # metas describe the WARPED geometry (inverse transforms read them)
        meta = dict(meta)
        if params['flip']:
            jci = meta['joint_channel_ind'].copy()
            jci[self.left_index] = self.right_index
            jci[self.right_index] = self.left_index
            meta['joint_channel_ind'] = jci
        meta['hflip'] = bool(params['flip'])
        meta['scale'] = meta['scale'] * np.array([sx, sy])
        meta['rotate'] = meta['rotate'] + params['rotate']
        meta['affine_mat'] = mat @ meta['affine_mat']
        meta['width_height'] = np.array([self.square, self.square])

        return {
            'image': raw,
            'mask_miss': raw_mask,
            'anns': self._pad_persons(anns),
            'aug_mat': mat.astype(np.float32),
            'aug_mat_inv': np.linalg.inv(mat)[:2].astype(np.float32),
            'aug_scale_xy': np.array([sx, sy], np.float32),
            'aug_flags': np.array([params['flip'], gray], np.float32),
            'aug_tint': tint,
            'valid_hw': np.array([h, w], np.int32),
            'meta': meta,
        }

    def get(self, index: int, rng: np.random.RandomState) -> Dict:
        if not self.device_aug:
            raise NotImplementedError(
                'the host augmentation route (the warp on the host, and the '
                'unaugmented validation samples) is not ported; construct '
                'the dataset with device_aug=True')
        img_id = self.ids[index]
        info = self.coco.image_info(img_id)
        path = os.path.join(self.image_dir, info['file_name'])
        image = read_image(path)
        if image is None:
            raise IOError(f'missing image: {path}')
        coco_anns = self.coco.anns_for_image(img_id)
        mask_miss, _ = build_miss_masks(coco_anns, info['height'],
                                        info['width'])
        anns = T.normalize_annotations(coco_anns, self.skeleton.sigmas,
                                       self.skeleton.n_keypoints)
        meta = T.make_meta(info['width'], info['height'],
                           self.skeleton.n_keypoints)
        meta['image_id'] = img_id
        return self._get_device_aug(image, anns, meta, mask_miss, rng)


def _batch_rng(seed: int, epoch: int, batch_index: int) -> np.random.RandomState:
    """Augmentation RNG derived from (seed, epoch, batch) alone, so batch
    contents do not depend on how batches are produced."""
    return np.random.RandomState(
        (seed * 1000003 + epoch * 8191 + batch_index) % (2 ** 31 - 1))


def _make_batch(dataset: CocoKeypoints, idx, rng, epoch: int) -> Dict:
    samples = [dataset.get(int(i), rng) for i in idx]
    keys = dataset.sample_spec().keys()
    batch = {k: np.stack([s[k] for s in samples]) for k in keys}
    batch.update(metas=[s['meta'] for s in samples], epoch=epoch)
    return batch


def _batch_plan(dataset, batch_size, seed, shuffle, drop_last, epochs):
    """Yields (global_batch_index, epoch, index_array). The shuffle stream
    depends only on `seed`."""
    order_rng = np.random.RandomState(seed)
    epoch, gb = 0, 0
    while epochs is None or epoch < epochs:
        order = np.arange(len(dataset))
        if shuffle:
            order_rng.shuffle(order)
        for start in range(0, len(order), batch_size):
            idx = order[start:start + batch_size]
            if len(idx) < batch_size and drop_last:
                continue
            yield gb, epoch, idx
            gb += 1
        epoch += 1


def batch_iterator(dataset: CocoKeypoints, batch_size: int, *,
                   seed: int = 0, shuffle: bool = True,
                   drop_last: bool = True, prefetch: int = 2,
                   epochs: Optional[int] = None,
                   num_workers: int = 0) -> Iterator[Dict]:
    """Prefetching batch iterator yielding stacked numpy batches, made by
    one background thread. Closing the iterator (or leaving a loop over it)
    stops the thread."""
    if num_workers > 0:
        raise NotImplementedError(
            'loader worker processes (num_workers > 0) are not ported; '
            'use num_workers=0 (one background thread)')
    done = object()
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for gb, epoch, idx in _batch_plan(dataset, batch_size, seed,
                                              shuffle, drop_last, epochs):
                if not put(_make_batch(dataset, idx,
                                       _batch_rng(seed, epoch, gb), epoch)):
                    return
        except Exception as e:      # surface in the consumer
            put(e)
            return
        put(done)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=10.0)
