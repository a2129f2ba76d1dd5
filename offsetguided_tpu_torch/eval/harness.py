"""Evaluation building blocks: preprocess, batched forward + decode, COCO
records.

Port of the JAX package's `eval/harness.py` for the long-edge mode: every
image is rescaled and center-padded to (long_edge, long_edge), uint8 goes
to the device, normalization runs there, and flip-test doubles the batch
inside the infer function. `run_images` / `validation` and the
fixed-height mode are not ported yet.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..config.defaults import EvalConfig
from ..data import transforms as T
from ..decoder import PostProcessor
from ..ops.image import normalize_images


def preprocess_eval(image: np.ndarray, anns: np.ndarray, cfg: EvalConfig,
                    n_keypoints: int = 17):
    """Rescale + center pad a uint8 RGB image; returns (image, anns, meta)
    with the image still uint8 (the device normalizes)."""
    if cfg.fixed_height:
        raise NotImplementedError('fixed-height eval is not ported yet')
    h, w = image.shape[:2]
    meta = T.make_meta(w, h, n_keypoints)
    image, anns, meta = T.rescale_long_absolute(image, anns, meta,
                                                cfg.long_edge)
    image, anns, meta = T.center_pad(image, anns, meta, cfg.long_edge)
    return image, anns, meta


def make_infer_fn(model: torch.nn.Module, pp: PostProcessor,
                  flip_test: bool):
    """images (N, H, W, 3) uint8 or normalized float on the model's device
    -> (poses, scores, counts), with the flipped half and its merge inside
    when `flip_test`. The function carries its `model` and `postprocessor`
    as attributes."""

    @torch.inference_mode()
    def infer(images: torch.Tensor):
        images = normalize_images(images)
        if flip_test:
            images = torch.cat([images, torch.flip(images, dims=(2,))])
        preds = model(images)
        return pp.decode_body(preds, flip_test=flip_test)

    infer.model, infer.postprocessor = model, pp
    return infer


def poses_to_coco_results(poses: np.ndarray, image_id: int) -> List[Dict]:
    """(M, J, 6) decoded poses -> COCO keypoint result dicts, with the
    dummy record when there is none."""
    results = []
    poses = poses.copy()
    poses[:, :, :2] = np.around(poses[:, :, :2], 2)
    for person in poses:
        if not np.any(person[:, :3]):
            continue
        v = person[:, 2]
        kps = []
        for x, y, vv in person[:, :3]:
            kps += [float(x), float(y), 1 if (x > 0 or y > 0) else 0]
        results.append({'image_id': image_id, 'category_id': 1,
                        'keypoints': kps, 'score': float(v.sum() / len(v))})
    if not results:
        results.append({'image_id': image_id, 'category_id': 1,
                        'keypoints': np.zeros(poses.shape[1] * 3).tolist(),
                        'score': 0.01})
    return results
