"""Eval-time rescale + pad, the inverse transform and COCO annotation
normalization, on numpy images.

Same coordinate conventions as the JAX package's `data/transforms.py`:
rescaling uses `(target-1)/(orig-1)` scale factors, padding fills
RGB(124,116,104), and `meta` records the forward mapping for the inverse.
The resize is torch bicubic (half-pixel, A=-0.75, edge clamp) rounded and
clamped to uint8 instead of `cv2.INTER_CUBIC`; the two differ by at most
one grey level (measured in tests/test_torch_port_e2e.py).
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

PAD_RGB = (124, 116, 104)


def make_meta(w: int, h: int, n_keypoints: int = 17) -> Dict:
    return {
        'joint_num': n_keypoints,
        'offset': np.array([0.0, 0.0]),
        'scale': np.array([1.0, 1.0]),
        'valid_area': np.array([0.0, 0.0, float(w), float(h)]),
        'hflip': False,
        'rotate': 0.0,
        'width_height': np.array([w, h]),
        'original_width_height': np.array([w, h]),
        'affine_mat': np.eye(3, dtype=np.float32),
        'joint_channel_ind': np.arange(n_keypoints),
    }


def normalize_annotations(coco_anns: List[Dict], sigmas,
                          n_keypoints: int = 17) -> np.ndarray:
    """COCO ann dicts -> (P, J, 4) [x, y, v, scale], scale = sqrt(bbox
    area) * OKS sigma; crowd and keypoint-less persons are dropped, and
    persons of area <= 32^2 keep their points with v = 0."""
    anns = [a for a in coco_anns
            if not a.get('iscrowd') and a.get('num_keypoints', 0) > 0]
    out = np.zeros((len(anns), n_keypoints, 4), dtype=np.float32)
    sig = np.asarray(sigmas, dtype=np.float32)
    for i, a in enumerate(anns):
        out[i, :, :3] = np.asarray(a['keypoints'],
                                   dtype=np.float32).reshape(-1, 3)
        scale = math.sqrt(max(a['bbox'][2] * a['bbox'][3], 0.0))
        out[i, :, 3] = scale * sig
        if a.get('area', 1e9) <= 32 * 32:
            out[i, :, 2] = 0
    return out


def resize_bicubic_u8(image: np.ndarray, target_w: int,
                      target_h: int) -> np.ndarray:
    """(H, W, 3) uint8 -> (target_h, target_w, 3) uint8, torch bicubic."""
    x = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)
    y = F.interpolate(x[None].float(), size=(target_h, target_w),
                      mode='bicubic', align_corners=False)[0]
    return y.round().clamp(0, 255).to(torch.uint8).permute(1, 2, 0).numpy()


def _scale_to(image, anns, meta, target_w, target_h):
    h, w = image.shape[:2]
    image = resize_bicubic_u8(image, target_w, target_h)
    x_scale = (target_w - 1) / (w - 1)
    y_scale = (target_h - 1) / (h - 1)
    anns = anns.copy()
    anns[:, :, 0] *= x_scale
    anns[:, :, 1] *= y_scale
    anns[:, :, 3] *= math.sqrt(x_scale * y_scale)
    meta = dict(meta)
    sf = np.array([x_scale, y_scale])
    meta['offset'] = meta['offset'] * sf
    meta['scale'] = meta['scale'] * sf
    meta['width_height'] = np.array([target_w, target_h])
    va = meta['valid_area'].copy()
    va[:2] *= sf
    va[2:] *= sf
    meta['valid_area'] = va
    return image, anns, meta


def rescale_long_absolute(image, anns, meta, long_edge: int):
    """Resize so the longer edge equals long_edge."""
    h, w = image.shape[:2]
    s = long_edge / max(h, w)
    if h > w:
        tw, th = int(w * s), long_edge
    else:
        tw, th = long_edge, int(h * s)
    return _scale_to(image, anns, meta, tw, th)


def rescale_high_absolute(image, anns, meta, height_edge: int):
    """Resize to a fixed height."""
    h, w = image.shape[:2]
    s = height_edge / h
    return _scale_to(image, anns, meta, int(w * s), int(height_edge))


def pad_with(image: np.ndarray, top: int, left: int, height: int,
             width: int) -> np.ndarray:
    """`image` placed at (top, left) on a (height, width) PAD_RGB canvas."""
    h, w = image.shape[:2]
    out = np.empty((height, width, 3), np.uint8)
    out[...] = np.asarray(PAD_RGB, np.uint8)
    out[top:top + h, left:left + w] = image
    return out


def center_pad(image, anns, meta, target_size: int):
    """Pad centered to (target, target) with PAD_RGB."""
    h, w = image.shape[:2]
    left = max((target_size - w) // 2, 0)
    top = max((target_size - h) // 2, 0)
    out = pad_with(image, top, left, max(h, target_size),
                   max(w, target_size))
    anns = anns.copy()
    anns[:, :, 0] += left
    anns[:, :, 1] += top
    meta = dict(meta)
    meta['offset'] = meta['offset'] - np.array([left, top])
    meta['width_height'] = np.array([out.shape[1], out.shape[0]])
    va = meta['valid_area'].copy()
    va[:2] += np.array([left, top])
    meta['valid_area'] = va
    return out, anns, meta


def rightdown_pad(image, anns, meta, max_stride: int,
                  w_multiple: int = None):
    """Pad right/bottom to a multiple of `max_stride`; `w_multiple`
    overrides the width multiple only (fixed-height eval pads widths to
    coarse buckets while the height keeps `max_stride` padding)."""
    h, w = image.shape[:2]
    wm = w_multiple or max_stride
    bottom = (max_stride - h % max_stride) % max_stride
    right = (wm - w % wm) % wm
    image = pad_with(image, 0, 0, h + bottom, w + right)
    meta = dict(meta)
    meta['width_height'] = np.array([image.shape[1], image.shape[0]])
    return image, anns.copy(), meta


def annotations_inverse(poses: np.ndarray, meta: Dict) -> np.ndarray:
    """Map decoded poses (M, J, >=4) back to original image coordinates."""
    poses = poses.copy()
    poses[:, :, 0] += meta['offset'][0]
    poses[:, :, 1] += meta['offset'][1]
    poses[:, :, 0] /= meta['scale'][0]
    poses[:, :, 1] /= meta['scale'][1]
    if poses.shape[-1] > 3:
        poses[:, :, 3] /= math.sqrt(float(np.prod(meta['scale'])))
    if meta.get('hflip'):
        raise NotImplementedError('hflip eval preprocessing is not used')
    return poses
