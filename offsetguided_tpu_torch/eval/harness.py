"""Evaluation: preprocess, batched forward + decode, COCO records, OKS AP.

Port of the JAX package's `eval/harness.py`. Long-edge mode rescales and
center-pads every image to (long_edge, long_edge); fixed-height mode
rescales to height `long_edge` and pads the width up to a multiple of
`width_bucket`, so an epoch runs a few distinct shapes, and `run_images`
orders images by aspect ratio and flushes a partial batch when the padded
shape changes. uint8 goes to the device, normalization runs there, and
flip-test doubles the batch inside the infer function. Images are read
with `data/coco.py::read_image` (JPEG and PNG through the port's codec,
`.npy` with numpy). The infer function and `run_images` record their
stages in `utils/profiling.RECORDER`.
"""
from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config.defaults import EvalConfig, SkeletonConfig
from ..data import transforms as T
from ..data.coco import CocoJson, read_image
from ..decoder import PostProcessor
from ..ops.image import normalize_images
from ..utils.profiling import RECORDER, DeviceGaps


def preprocess_eval(image: np.ndarray, anns: np.ndarray, cfg: EvalConfig,
                    n_keypoints: int = 17):
    """Rescale + pad a uint8 RGB image; returns (image, anns, meta) with
    the image still uint8 (the device normalizes)."""
    h, w = image.shape[:2]
    meta = T.make_meta(w, h, n_keypoints)
    if not cfg.fixed_height:
        image, anns, meta = T.rescale_long_absolute(image, anns, meta,
                                                    cfg.long_edge)
        return T.center_pad(image, anns, meta, cfg.long_edge)
    image, anns, meta = T.rescale_high_absolute(image, anns, meta,
                                                cfg.long_edge)
    # only the width pads to the bucket; the height keeps max_stride
    bucket = max(cfg.width_bucket, cfg.max_stride)
    if bucket % cfg.max_stride != 0:
        raise ValueError(
            f'--width-bucket ({cfg.width_bucket}) must be a multiple of '
            f'--max-stride ({cfg.max_stride}); effective bucket {bucket} '
            f'is not')
    return T.rightdown_pad(image, anns, meta, cfg.max_stride,
                           w_multiple=bucket)


def make_infer_fn(model: torch.nn.Module, pp: PostProcessor,
                  flip_test: bool):
    """images (N, H, W, 3) uint8 or normalized float on the model's device
    -> (poses, scores, counts), with the flipped half and its merge inside
    when `flip_test`. The function carries its `model` and `postprocessor`
    as attributes. Its spans `infer.forward` (normalization, flip concat,
    model) and `infer.decode` (`decode_body`) time the host's issue of
    their launches, as stages of the calling thread's current batch."""

    @torch.inference_mode()
    def infer(images: torch.Tensor):
        stage = RECORDER.start('infer.forward')
        images = normalize_images(images)
        if flip_test:
            images = torch.cat([images, torch.flip(images, dims=(2,))])
        preds = model(images)
        RECORDER.stop(stage)
        stage = RECORDER.start('infer.decode')
        out = pp.decode_body(preds, flip_test=flip_test)
        RECORDER.stop(stage)
        return out

    infer.model, infer.postprocessor = model, pp
    return infer


def poses_to_coco_results(poses: np.ndarray, image_id: int) -> List[Dict]:
    """(M, J, 6) decoded poses -> COCO keypoint result dicts, with the
    dummy record when there is none. The JAX package's per-keypoint loop
    with its values and types (x, y rounded to 2 decimals as float32 then
    Python floats, visibility a Python int, score the float32 mean of a
    pose's scores), read from whole-array lists: the launching loop writes
    these records while the card runs the next batch."""
    xy = np.around(poses[:, :, :2], 2)
    v = poses[:, :, 2]
    seen = (xy != 0).any(axis=(1, 2)) | (v != 0).any(axis=1)
    on = ((xy[..., 0] > 0) | (xy[..., 1] > 0)).astype(np.int64)
    xs, ys, ons = xy[..., 0].tolist(), xy[..., 1].tolist(), on.tolist()
    results = [{'image_id': image_id, 'category_id': 1,
                'keypoints': [c for k in zip(xs[p], ys[p], ons[p]) for c in k],
                'score': float(v[p].sum() / len(v[p]))}
               for p in np.flatnonzero(seen).tolist()]
    if not results:
        results.append(_dummy_record(image_id, poses.shape[1]))
    return results


def _dummy_record(image_id: int, n_keypoints: int) -> Dict:
    return {'image_id': image_id, 'category_id': 1,
            'keypoints': np.zeros(n_keypoints * 3).tolist(), 'score': 0.01}


def _load_eval_image(coco: CocoJson, image_dir: str, img_id: int,
                     cfg: EvalConfig, n_keypoints: int):
    """IO + preprocess for one image on a worker thread:
    (img_id, uint8 image | None, meta | None)."""
    path = os.path.join(image_dir, coco.image_info(img_id)['file_name'])
    img = read_image(path)
    if img is None:
        logging.getLogger(__name__).warning(
            'unreadable image %s (id %s): emitting dummy record',
            path, img_id)
        return img_id, None, None
    img, _, meta = preprocess_eval(
        img, np.zeros((0, n_keypoints, 4), np.float32), cfg, n_keypoints)
    return img_id, img, meta


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of device tensor `t` into pinned host memory, enqueued on the
    current stream without waiting for it."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def eval_image_ids(coco: CocoJson, n_images: Optional[int] = None,
                   all_images: bool = False) -> List[int]:
    """The image set `run_images` evaluates: person images (or all images,
    the test-dev protocol), sorted, optionally truncated. The metric must
    be restricted to the same set."""
    ids = coco.image_ids(with_persons=not all_images)
    return ids[:n_images] if n_images else ids


def run_images(model: torch.nn.Module, pp: PostProcessor, coco: CocoJson,
               image_dir: str, cfg: EvalConfig,
               n_images: Optional[int] = None,
               skeleton: Optional[SkeletonConfig] = None,
               progress: bool = False, all_images: bool = False
               ) -> List[Dict]:
    """Evaluate `model` (on its device) over a COCO image set; returns the
    result dicts. `cfg.io_workers` threads read and preprocess ahead of the
    device loop through a bounded ordered window, and batch N's poses are
    fetched only after batch N+1 is dispatched, so host work overlaps the
    device. Fixed-height batches hold one padded shape: images go in
    aspect-ratio order and a partial batch is flushed when the shape
    changes (per-image decode is batch-independent, so the records equal
    batch-1 records).

    On a CUDA device nothing in a dispatch waits for the device: the batch
    is stacked into pinned host memory and copied without blocking, the
    infer function issues without a host sync, and the poses and counts
    are copied back into pinned memory behind one event, which the fetch
    of that batch alone waits for. So batch N+1 is issued while N runs,
    and N's records are written while N+1 runs. The caching host
    allocator hands no pinned block out again before the copies that used
    it have ended.

    Each batch records in `RECORDER` its spans `eval.io_wait` (a wait for
    an IO worker's image, one an image), `eval.stack`, `eval.h2d`,
    `infer.*`, `eval.fetch` and `eval.records`; whether the previous
    batch was still in flight on the device when its input copy was
    enqueued (an event query; never on a CPU device); and on a CUDA device
    the idle gap since the previous batch, read after its fetch."""
    skeleton = skeleton or SkeletonConfig()
    n_kp = skeleton.n_keypoints
    device = next(model.parameters()).device
    ids = eval_image_ids(coco, n_images=n_images, all_images=all_images)
    batch_size = cfg.batch_size
    if cfg.fixed_height and batch_size > 1:
        def aspect(i):
            info = coco.image_info(i)
            return info['width'] / max(info['height'], 1)
        ids = sorted(ids, key=aspect)
    infer = make_infer_fn(model, pp, cfg.flip_test)
    cuda = device.type == 'cuda'

    results: List[Dict] = []
    # (poses, counts, ready event | None), metas, ids, n, batch: awaiting
    # its fetch; on a CUDA device poses and counts are pinned host copies
    pending = None
    rec, gaps = RECORDER, DeviceGaps(device)
    seq = rec.new_batch()           # the batch being filled

    def drain():
        nonlocal pending
        if pending is None:
            return
        (poses, counts, ready), metas, bids, n, b = pending
        pending = None
        stage = rec.start('eval.fetch')
        if ready is not None:
            ready.synchronize()
        poses, counts = poses.numpy(), counts.numpy()
        rec.stop(stage, b)
        gaps.read(b)
        stage = rec.start('eval.records')
        for i in range(n):
            # drop the zero pose rows before the inverse transform, which
            # would shift them into spurious detections
            inv = T.annotations_inverse(poses[i][:int(counts[i])], metas[i])
            results.extend(poses_to_coco_results(inv, bids[i]))
        rec.stop(stage, b)

    def dispatch(imgs, metas, bids, b):
        n = len(imgs)
        stage = rec.start('eval.stack')
        stacked = torch.empty((batch_size,) + imgs[0].shape,
                              dtype=torch.uint8, pin_memory=cuda)
        host = stacked.numpy()
        np.stack(imgs, out=host[:n])
        host[n:] = 0
        rec.stop(stage, b)
        gaps.begin(b)
        stage = rec.start('eval.h2d')
        x = stacked.to(device, non_blocking=True)
        rec.stop(stage, b)
        before = pending[0][2] if pending is not None else None
        rec.overlaps.append((b, before is not None and not before.query()))
        poses, _, counts = infer(x)
        ready = None
        if cuda:
            poses, counts = _pinned_copy(poses), _pinned_copy(counts)
            ready = torch.cuda.Event()
            ready.record()
        gaps.end(b)
        return (poses, counts, ready), metas, bids, n, b

    n_workers = max(1, cfg.io_workers)
    window = max(batch_size * 2, n_workers * 2)
    batch_imgs, batch_metas, batch_ids = [], [], []

    def flush():
        nonlocal pending, batch_imgs, batch_metas, batch_ids, seq
        nxt = dispatch(batch_imgs, batch_metas, batch_ids, seq)
        drain()                    # host work overlaps the running batch
        pending = nxt
        batch_imgs, batch_metas, batch_ids = [], [], []
        seq = rec.new_batch()

    with ThreadPoolExecutor(max_workers=n_workers) as ex:
        futures, submitted, done = [], 0, 0

        def submit_more():
            nonlocal submitted
            while submitted < len(ids) and len(futures) < window:
                futures.append(ex.submit(_load_eval_image, coco, image_dir,
                                         ids[submitted], cfg, n_kp))
                submitted += 1

        submit_more()
        while futures:
            stage = rec.start('eval.io_wait')
            img_id, img, meta = futures.pop(0).result()
            rec.stop(stage, seq)
            submit_more()
            done += 1
            if img is None:
                # every listed image gets a record (test-dev protocol)
                results.append(_dummy_record(img_id, n_kp))
            else:
                if batch_imgs and img.shape != batch_imgs[0].shape:
                    flush()            # fixed height: the padded width changed
                batch_imgs.append(img)
                batch_metas.append(meta)
                batch_ids.append(img_id)
                if len(batch_imgs) == batch_size:
                    flush()
            if progress and done % 100 == 0:
                print(f'eval {done}/{len(ids)}')
    if batch_imgs:
        flush()
    drain()
    return results


def validation(model: torch.nn.Module, pp: PostProcessor, ann_file: str,
               image_dir: str, cfg: EvalConfig, n_images=None,
               skeleton=None) -> Dict[str, float]:
    """COCO validation -> OKS metrics over the evaluated images."""
    from .cocoeval import evaluate_coco_keypoints
    skeleton = skeleton or SkeletonConfig()
    coco = CocoJson(ann_file)
    results = run_images(model, pp, coco, image_dir, cfg, n_images=n_images,
                         skeleton=skeleton)
    return evaluate_coco_keypoints(
        coco, results, skeleton.sigmas,
        image_ids=eval_image_ids(coco, n_images=n_images))
