"""Eval-time rescale + pad, the inverse transform, COCO annotation
normalization and the train-time augmentation, on numpy images.

The augmentation parameters (`sample_affine_params`, `annotation_jitter`,
`color_tint`) make the same `np.random.RandomState` draws in the same
order as the JAX package's, and `build_affine_mat` composes the same 3x3
matrix center2center @ zero2center @ flip @ scale @ rotate @ center2zero.
On the device-augmentation route the pixel work runs on the device
(`ops/augment.py`); on the host route `warp_affine`, `to_gray` and
`color_tint` give the values of the JAX package's cv2 calls without
OpenCV (`data/pixels.py`, identical value for value). The optional
photometric transforms `jpeg_compression` and `blur` (no entry point calls
them; they and the combinators `compose`, `random_apply` and
`multi_scale` are the JAX package's public augmentation API) give the
values of its cv2 calls too, through the port's codec and
`pixels.gaussian_blur_u8`.

Same coordinate conventions as the JAX package's `data/transforms.py`:
rescaling uses `(target-1)/(orig-1)` scale factors, padding fills
RGB(124,116,104), and `meta` records the forward mapping for the inverse.
The resize gives the values of the JAX package's `cv2.resize(...,
INTER_CUBIC)` without OpenCV (`data/pixels.py::resize_cubic_u8`, value for
value for sources of at least 4 x 4 pixels).
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from ..config import DATA_MEAN, DATA_STD
from . import codec, pixels

PAD_RGB = (124, 116, 104)
JPEG_MAX_SIDE = 65500        # libjpeg's JPEG_MAX_DIMENSION


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


def annotation_jitter(anns: np.ndarray, rng: np.random.RandomState,
                      epsilon: float = 0.5) -> np.ndarray:
    """+-epsilon/2-uniform coordinate jitter."""
    anns = anns.copy()
    anns[:, :, :2] += epsilon * (rng.rand(*anns[:, :, :2].shape) - 0.5) * 2.0
    return anns


def _roi_center(anns, meta):
    vis = anns[:, :, 2] > 0
    if not len(anns) or not vis.any():
        return meta['width_height'].astype(np.float32) // 2
    xs = anns[:, :, 0][vis]
    ys = anns[:, :, 1][vis]
    return np.array([(xs.min() + xs.max()) // 2,
                     (ys.min() + ys.max()) // 2], dtype=np.float32)


def sample_affine_params(aug, rng: np.random.RandomState) -> Dict:
    """Flip, rotation, scale, stretch and offset drawn from `aug`
    (an `AugmentationConfig`)."""
    return dict(
        flip=bool(rng.rand() < aug.flip_prob),
        rotate=float((rng.rand() * 2 - 1) * aug.max_rotate),
        scale=float(aug.min_scale + (aug.max_scale - aug.min_scale) * rng.rand()),
        x_stretch=float(aug.min_stretch
                        + (aug.max_stretch - aug.min_stretch) * rng.rand()),
        y_stretch=float(aug.min_stretch
                        + (aug.max_stretch - aug.min_stretch) * rng.rand()),
        x_offset=int((rng.rand() * 2 - 1) * aug.max_translate),
        y_offset=int((rng.rand() * 2 - 1) * aug.max_translate),
    )


IDENTITY_PARAMS = dict(flip=False, rotate=0.0, scale=1.0, x_stretch=1.0,
                       y_stretch=1.0, x_offset=0, y_offset=0)


def build_affine_mat(params: Dict, roi_center, src_wh, dst_wh,
                     crop_roi: bool = True):
    """One 3x3 float64 matrix composing flip/scale/rotate/translate, and
    the x and y scales: (mat, scale_x, scale_y)."""
    cangle = math.cos(math.radians(params['rotate']))
    sangle = math.sin(math.radians(params['rotate']))
    scale_x = params['x_stretch'] * params['scale']
    scale_y = params['y_stretch'] * params['scale']

    center = (np.asarray(src_wh, dtype=np.float32) - 1) / 2
    move2roi = center - roi_center
    tx = params['x_offset'] + (move2roi[0] * scale_x if crop_roi else 0)
    ty = params['y_offset'] + (move2roi[1] * scale_y if crop_roi else 0)

    center2zero = np.array([[1, 0, -center[0]], [0, 1, -center[1]], [0, 0, 1]])
    rotate = np.array([[cangle, sangle, 0], [-sangle, cangle, 0], [0, 0, 1]])
    scale = np.array([[scale_x, 0, 0], [0, scale_y, 0], [0, 0, 1]])
    flip = np.array([[-1.0 if params['flip'] else 1.0, 0, 0], [0, 1, 0],
                     [0, 0, 1]])
    zero2center = np.array([[1, 0, (dst_wh[0] - 1) / 2],
                            [0, 1, (dst_wh[1] - 1) / 2], [0, 0, 1]])
    center2center = np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1]])

    mat = center2center @ zero2center @ flip @ scale @ rotate @ center2zero
    return mat.astype(np.float64), scale_x, scale_y


def warp_affine(image, anns, meta, mask_miss, params: Dict, dst_size: int,
                left_index, right_index, crop_roi: bool = True):
    """The sampled affine applied to the image (cubic, PAD_RGB border), the
    miss mask (cubic, border 255: not binary afterwards), the keypoints
    (xy through the matrix, scale * sqrt(sx * sy), left/right swapped under
    flip, v = 0 off the canvas) and `meta`."""
    in_size = [dst_size, dst_size]
    roi_center = _roi_center(anns, meta)
    mat, scale_x, scale_y = build_affine_mat(
        params, roi_center, meta['width_height'], in_size, crop_roi)
    M = mat[:2]

    image = pixels.warp_affine_u8_native(image, M, in_size[1], in_size[0],
                                         PAD_RGB)
    if mask_miss is not None:
        mask_miss = pixels.warp_affine_u8_native(mask_miss, M, in_size[1],
                                                 in_size[0], 255)

    anns = anns.copy()
    if len(anns):
        homo = np.concatenate(
            [anns[:, :, :2], np.ones_like(anns[:, :, :1])], axis=-1)
        anns[:, :, :2] = np.einsum('ij,pkj->pki', M, homo)
        anns[:, :, 3] *= math.sqrt(scale_x * scale_y)

    meta = dict(meta)
    left_index, right_index = list(left_index), list(right_index)
    if params['flip'] and len(anns):
        tmp_l = anns[:, left_index, :].copy()
        anns[:, left_index, :] = anns[:, right_index, :]
        anns[:, right_index, :] = tmp_l
        jci = meta['joint_channel_ind'].copy()
        jci[left_index] = right_index
        jci[right_index] = left_index
        meta['joint_channel_ind'] = jci

    if len(anns):
        off = ((anns[:, :, 0] <= 0) | (anns[:, :, 1] <= 0)
               | (anns[:, :, 0] > in_size[0]) | (anns[:, :, 1] > in_size[1]))
        anns[:, :, 2] = np.where(off, 0.0, anns[:, :, 2])

    meta['hflip'] = bool(params['flip'])
    meta['scale'] = meta['scale'] * np.array([scale_x, scale_y])
    meta['rotate'] = meta['rotate'] + params['rotate']
    meta['affine_mat'] = mat @ meta['affine_mat']
    meta['width_height'] = np.array(in_size)
    return image, anns, meta, mask_miss


def to_gray(image: np.ndarray) -> np.ndarray:
    """cv2's RGB2GRAY, repeated into three channels."""
    return np.repeat(pixels.rgb_to_gray_u8(image)[:, :, None], 3, axis=2)


def color_tint(image: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Random HSV shifts (hue in [0, 180), three `randint` draws: hue,
    saturation, value)."""
    hsv = pixels.rgb_to_hsv_u8(image).astype(np.int32)
    hsv[:, :, 0] = (hsv[:, :, 0] + rng.randint(-10, 11)) % 180
    hsv[:, :, 1] = np.clip(hsv[:, :, 1] + rng.randint(-40, 41), 0, 255)
    hsv[:, :, 2] = np.clip(hsv[:, :, 2] + rng.randint(-30, 31), 0, 255)
    return pixels.hsv_to_rgb_u8(hsv.astype(np.uint8))


def jpeg_compression(image: np.ndarray, rng: np.random.RandomState,
                     quality_range=(50, 95)) -> np.ndarray:
    """Random JPEG re-compression: quality q = rng.randint(lo, hi + 1), the
    RGB image encoded as cv2.imencode encodes it at q and decoded as
    cv2.imdecode decodes it. Where cv2.imencode fails (a side above
    65500) the JAX package returns the input unchanged, and so does
    this."""
    q = int(rng.randint(quality_range[0], quality_range[1] + 1))
    if max(image.shape[:2]) > JPEG_MAX_SIDE:
        return image
    return codec.decode_jpeg(codec.encode_jpeg(image, q))


def blur(image: np.ndarray, rng: np.random.RandomState,
         max_sigma: float = 2.0) -> np.ndarray:
    """Random Gaussian blur: sigma = 0.3 + rng.rand() * (max_sigma - 0.3),
    then cv2.GaussianBlur(image, (0, 0), sigma)'s uint8 values."""
    sigma = 0.3 + rng.rand() * (max_sigma - 0.3)
    return pixels.gaussian_blur_u8(image, sigma)


def normalize_image(image: np.ndarray) -> np.ndarray:
    """uint8 RGB -> float32, ImageNet-normalized."""
    img = image.astype(np.float32) / 255.0
    return (img - np.asarray(DATA_MEAN, np.float32)) / np.asarray(
        DATA_STD, np.float32)


def compose(*fns):
    """Chain transforms of signature (image, anns, meta, mask) -> the same
    tuple."""
    def run(image, anns, meta, mask_miss=None):
        for f in fns:
            image, anns, meta, mask_miss = f(image, anns, meta, mask_miss)
        return image, anns, meta, mask_miss
    return run


def random_apply(fn, prob: float, rng: np.random.RandomState):
    """Apply `fn` when rng.rand() < prob (one draw a call)."""
    def run(image, anns, meta, mask_miss=None):
        if rng.rand() < prob:
            return fn(image, anns, meta, mask_miss)
        return image, anns, meta, mask_miss
    return run


def multi_scale(*pipelines):
    """Fan one sample out to N pipelines: the list of their outputs."""
    def run(image, anns, meta, mask_miss=None):
        return [p(image, anns, meta, mask_miss) for p in pipelines]
    return run


def resize_bicubic_u8(image: np.ndarray, target_w: int,
                      target_h: int) -> np.ndarray:
    """(H, W, 3) uint8 -> (target_h, target_w, 3) uint8: cv2.resize's
    INTER_CUBIC, computed in C++ (`pixels.resize_cubic_u8_native`)."""
    return pixels.resize_cubic_u8_native(image, target_w, target_h)


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


def rescale_relative(image, anns, meta, scale_factor: float):
    """Resize by a relative factor (each side truncated)."""
    h, w = image.shape[:2]
    return _scale_to(image, anns, meta,
                     int(w * scale_factor), int(h * scale_factor))


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


def square_pad(image, anns, meta):
    """Center-pad to a square of the longer edge."""
    return center_pad(image, anns, meta, max(image.shape[:2]))


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


def affine_keypoint_inverse(poses: np.ndarray, meta: Dict) -> np.ndarray:
    """Map poses (M, J, >=3) decoded on a train-time warped sample back
    through the inverse of `meta['affine_mat']`, scales by sqrt of the
    product of `meta['scale']`, and the keypoints back into their channels
    (`meta['joint_channel_ind']`, swapped under flip)."""
    poses = poses.copy()
    Minv = np.linalg.inv(meta['affine_mat'])[:2]
    homo = np.concatenate([poses[:, :, :2], np.ones_like(poses[:, :, :1])],
                          axis=-1)
    poses[:, :, :2] = np.einsum('ij,pkj->pki', Minv, homo)
    if poses.shape[-1] > 3:
        poses[:, :, 3] /= math.sqrt(float(np.prod(meta['scale'])))
    return poses[:, meta['joint_channel_ind'], :]
