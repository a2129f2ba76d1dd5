"""Training and validation datasets + batching on the host.

Port of the JAX package's `data/pipeline.py`, both routes:
- host augmentation (the default): the host reads the image, renders the
  miss mask, jitters the annotations, warps image and mask to the
  (S, S) square and applies the photometric pass (`data/transforms.py`,
  the values of the JAX package's cv2 calls), and pads annotations to a
  fixed `(max_persons, J, 4)` array; with `aug=None` the warp is the
  identity placement (the validation samples);
- device augmentation (`device_aug=True`): the host samples every
  augmentation parameter and ships the raw image on a fixed canvas; the
  warp and the photometric pass run batched on the device
  (`ops/augment.py`).
GT encoding and mask downscaling run on the device on both routes
(`ops/encoder.py`). Batches come from one background thread
(`num_workers=0`) or from worker processes that write them into shared
memory; a batch's randomness depends only on (seed, epoch, batch), so its
contents are the same for any worker count.
"""
from __future__ import annotations

import logging
import os
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..config.defaults import AugmentationConfig, SkeletonConfig
from . import codec
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
    """COCO keypoint dataset.

    `get(i, rng)` returns a dict of fixed-shape arrays (`sample_spec`) and
    meta. Host route: the warped (S, S, 3) uint8 image, its (S, S) uint8
    mask_miss in [0, 255] (cubic-warped, border 255) and the padded
    annotations. Device-aug route: the raw image on a (raw_canvas,
    raw_canvas, 3) uint8 canvas (top-left anchored), its mask_miss (0/255
    uint8, 255 outside the image), the padded annotations and the
    host-sampled augmentation parameters. The dataset holds no tensor, so
    it pickles to spawned worker processes.
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
        if not device_aug:      # a missing compiler fails here, not later
            from ..ops.cuda import _build
            _build.library('host_warp')

    def __len__(self):
        return len(self.ids)

    def _pad_persons(self, anns: np.ndarray) -> np.ndarray:
        J = self.skeleton.n_keypoints
        out = np.zeros((self.max_persons, J, 4), dtype=np.float32)
        p = min(len(anns), self.max_persons)
        out[:p] = anns[:p]
        return out

    def sample_spec(self) -> Dict:
        """Per-sample array layout: key -> (shape, dtype). Drives batch
        stacking and the shared-memory transport (`_ShmSlots`)."""
        J = self.skeleton.n_keypoints
        S = self.raw_canvas if self.device_aug else self.square
        spec = {
            'image': ((S, S, 3), np.uint8),
            'mask_miss': ((S, S), np.uint8),
            'anns': ((self.max_persons, J, 4), np.float32),
        }
        if self.device_aug:
            spec.update({
                'aug_mat': ((3, 3), np.float32),       # src->dst forward
                'aug_mat_inv': ((2, 3), np.float32),   # dst->src (sampling)
                'aug_scale_xy': ((2,), np.float32),
                'aug_flags': ((2,), np.float32),       # [flip, gray]
                'aug_tint': ((4,), np.float32),        # [on, dh, ds, dv]
                'valid_hw': ((2,), np.int32),
            })
        return spec

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

    def _get_host(self, image, anns, meta, mask_miss,
                  rng: np.random.RandomState) -> Dict:
        """The sample warped to the (S, S) square on the host: jitter,
        affine, gray, tint, drawn from `rng` in the JAX package's order;
        the identity placement when `aug` is None."""
        aug = self.aug
        if aug is not None:
            if rng.rand() < aug.annotation_jitter_prob:
                anns = T.annotation_jitter(anns, rng)
            params = T.sample_affine_params(aug, rng)
        else:
            params = T.IDENTITY_PARAMS
        image, anns, meta, mask_miss = T.warp_affine(
            image, anns, meta, mask_miss, params, self.square,
            self.left_index, self.right_index)
        if aug is not None:
            if rng.rand() < aug.gray_prob:
                image = T.to_gray(image)
            if rng.rand() < aug.color_tint_prob:
                image = T.color_tint(image, rng)
        return {
            'image': np.ascontiguousarray(image, dtype=np.uint8),
            'anns': self._pad_persons(anns),
            'mask_miss': mask_miss.astype(np.uint8),
            'meta': meta,
        }

    def get(self, index: int, rng: np.random.RandomState) -> Dict:
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
        if self.device_aug:
            return self._get_device_aug(image, anns, meta, mask_miss, rng)
        return self._get_host(image, anns, meta, mask_miss, rng)


class ImageList:
    """Inference-only dataset over a list of image paths. `get(i)` reads
    image i as cv2.imread does (JPEG or PNG through the port's codec, EXIF
    orientation applied), in RGB, and raises IOError where the file is
    missing or not an image the codec reads."""

    def __init__(self, image_paths):
        self.image_paths = list(image_paths)

    def __len__(self):
        return len(self.image_paths)

    def get(self, index: int) -> Dict:
        path = self.image_paths[index]
        image = codec.imread(path)
        if image is None:
            raise IOError(f'missing image: {path}')
        return {'image': image,
                'meta': {'dataset_index': index, 'file_name': path}}


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


class _ShmSlots:
    """Fixed-size shared-memory slots, one batch each, laid out by the
    dataset's `sample_spec()`: a worker writes a batch into its slot once
    and the parent copies it out once; only the indices and metas travel
    through a queue. The parent creates (and unlinks) the segments; the
    workers attach to them."""

    def __init__(self, batch_size: int, sample_spec: Dict, n_slots: int):
        self.keys = list(sample_spec.keys())
        self.shapes = {k: (batch_size,) + tuple(shape)
                       for k, (shape, _) in sample_spec.items()}
        self.dtypes = {k: dt for k, (_, dt) in sample_spec.items()}
        self.offsets, off = {}, 0
        for k in self.keys:
            self.offsets[k] = off
            off += int(np.prod(self.shapes[k])) * np.dtype(
                self.dtypes[k]).itemsize
        self.nbytes = off
        self.n_slots = n_slots
        self._segs = None

    def __getstate__(self):
        # spawn pickles this to the workers: the layout only, never the
        # parent's open segments
        return {k: v for k, v in self.__dict__.items() if k != '_segs'}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._segs = None

    def create(self) -> List[str]:
        from multiprocessing import shared_memory
        self._segs = [shared_memory.SharedMemory(create=True,
                                                 size=self.nbytes)
                      for _ in range(self.n_slots)]
        return [seg.name for seg in self._segs]

    def attach(self, names) -> None:
        from multiprocessing import resource_tracker, shared_memory
        # Python < 3.13 registers an attachment with the resource tracker
        # too (bpo-39959), and spawned children share the parent's tracker:
        # unregistering afterwards would drop the parent's own registration
        # and its unlink() would then fail inside the tracker. So the
        # registration is suppressed instead (3.13 has track=False).
        orig = resource_tracker.register
        resource_tracker.register = (
            lambda name, rtype: None if rtype == 'shared_memory'
            else orig(name, rtype))
        try:
            self._segs = [shared_memory.SharedMemory(name=n) for n in names]
        finally:
            resource_tracker.register = orig

    def views(self, slot: int) -> Dict[str, np.ndarray]:
        buf = self._segs[slot].buf
        return {k: np.ndarray(self.shapes[k], self.dtypes[k], buffer=buf,
                              offset=self.offsets[k])
                for k in self.keys}

    def close(self, unlink: bool) -> None:
        for seg in self._segs or []:
            seg.close()
            if unlink:
                seg.unlink()
        self._segs = None


def _worker_loop(dataset, seed, task_q, result_q, slots: _ShmSlots,
                 shm_names):
    """A loader process (numpy and the host warp; it never touches a
    device): makes each batch it is given into its shared-memory slot and
    reports (batch, slot, size, metas, epoch, error)."""
    slots.attach(shm_names)
    try:
        while True:
            task = task_q.get()
            if task is None:
                return
            gb, epoch, idx, slot = task
            try:
                batch = _make_batch(dataset, idx,
                                    _batch_rng(seed, epoch, gb), epoch)
                v = slots.views(slot)
                n = batch['image'].shape[0]
                for k in slots.keys:
                    v[k][:n] = batch[k]
                result_q.put((gb, slot, n, batch['metas'], epoch, None))
            except Exception as e:      # reported to the parent
                result_q.put((gb, -1, 0, None, epoch,
                              f'{type(e).__name__}: {e}'))
    finally:
        slots.close(unlink=False)


def _mp_batch_iterator(dataset, batch_size, seed, shuffle, drop_last,
                       prefetch, epochs, num_workers) -> Iterator[Dict]:
    """`num_workers` loader processes (spawned: the parent may hold CUDA).
    Batches travel through shared-memory slots and are put back in order
    in the parent, so contents and order equal the serial path's. Closing
    the iterator stops the workers and unlinks the segments."""
    import multiprocessing as mp
    ctx = mp.get_context('spawn')
    max_in_flight = num_workers + max(prefetch, 1)
    slots = _ShmSlots(batch_size, dataset.sample_spec(),
                      n_slots=max_in_flight)
    shm_names = slots.create()
    task_q = ctx.Queue()
    result_q = ctx.Queue()
    workers = [ctx.Process(target=_worker_loop,
                           args=(dataset, seed, task_q, result_q, slots,
                                 shm_names),
                           daemon=True)
               for _ in range(num_workers)]
    try:
        for w in workers:
            w.start()
        plan = _batch_plan(dataset, batch_size, seed, shuffle, drop_last,
                           epochs)
        pending: Dict[int, Dict] = {}
        free_slots = list(range(max_in_flight))
        in_flight, next_emit, exhausted = 0, 0, False
        while True:
            while free_slots and not exhausted:
                task = next(plan, None)
                if task is None:
                    exhausted = True
                    break
                gb, epoch, idx = task
                task_q.put((gb, epoch, idx, free_slots.pop()))
                in_flight += 1
            if in_flight == 0:
                return
            while True:
                # a worker killed mid-batch never reports: poll liveness
                try:
                    gb, slot, n, metas, epoch, err = result_q.get(timeout=5.0)
                    break
                except queue.Empty:
                    dead = [w for w in workers if not w.is_alive()]
                    if dead:
                        raise RuntimeError(
                            f'{len(dead)} loader worker(s) died without a '
                            f'result (exit codes '
                            f'{[w.exitcode for w in dead]}); likely an OOM '
                            'kill -- reduce --loader-workers or the batch '
                            'size')
            in_flight -= 1
            if err is not None:
                raise RuntimeError(f'loader worker failed on batch {gb}: '
                                   f'{err}')
            v = slots.views(slot)
            pending[gb] = {k: v[k][:n].copy() for k in slots.keys}
            pending[gb].update(metas=metas, epoch=epoch)
            free_slots.append(slot)
            while next_emit in pending:
                yield pending.pop(next_emit)
                next_emit += 1
    finally:
        started = [w for w in workers if w.pid is not None]
        for w in started:
            if w.is_alive():
                task_q.put(None)
        # drain results while the workers finish: one blocked writing to a
        # full result pipe exits only once it is read
        end = time.monotonic() + 10.0
        while (any(w.is_alive() for w in started)
               and time.monotonic() < end):
            try:
                result_q.get(timeout=0.1)
            except queue.Empty:
                pass
        for w in started:
            if w.is_alive():
                w.terminate()
            w.join(timeout=5.0)
        task_q.cancel_join_thread()     # unread tasks die with the queue
        task_q.close()
        result_q.close()
        slots.close(unlink=True)


def batch_iterator(dataset: CocoKeypoints, batch_size: int, *,
                   seed: int = 0, shuffle: bool = True,
                   drop_last: bool = True, prefetch: int = 2,
                   epochs: Optional[int] = None,
                   num_workers: int = 0) -> Iterator[Dict]:
    """Prefetching batch iterator yielding stacked numpy batches, made by
    one background thread (`num_workers=0`) or by that many loader
    processes. Contents and order are the same for every worker count.
    Closing the iterator (or leaving a loop over it) stops the thread or
    the processes."""
    if num_workers > 0:
        yield from _mp_batch_iterator(dataset, batch_size, seed, shuffle,
                                      drop_last, prefetch, epochs,
                                      num_workers)
        return
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
