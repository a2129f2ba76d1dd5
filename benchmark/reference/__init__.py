"""The benchmark's plain reference: network, decode, padding and inverse.

`make_infer` composes `model.PlainPoseNet` and `decode.PostProcessor` into
the function the port's `eval/harness.py::make_infer_fn` makes: uint8
(N, H, W, 3) on the device -> (poses, scores, counts) in network-input
pixels, the flipped half and its merge inside when `flip`. `pad_long_edge`
/ `pad_fixed_height` repeat the port's preprocessing for scenes that need
no rescale (their long edge, or their height, is already the target), and
`to_image` maps poses back. Nothing here imports the port.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .decode import DecoderConfig, PostProcessor, Skeleton
from .model import PlainPoseNet, normalize

PAD_RGB = (124, 116, 104)


def skeleton(cfg: Dict) -> Skeleton:
    return Skeleton(tuple(cfg['keypoints']),
                    tuple(tuple(l) for l in cfg['skeleton']))


def decoder_config(cfg: Dict, lowres: bool) -> DecoderConfig:
    return DecoderConfig(upsampled_decode=not lowres, **cfg['decoder'])


class Net(torch.nn.Module):
    """`PlainPoseNet` as a module, so hooks and `parameters()` work on it
    as on the port's network (one frozen parameter gives the device)."""

    def __init__(self, plain: PlainPoseNet, device):
        super().__init__()
        self.plain = plain
        self.anchor = torch.nn.Parameter(torch.zeros(1, device=device),
                                         requires_grad=False)

    def forward(self, images):
        return self.plain(images)


def make_infer(cfg: Dict, sd: Dict[str, torch.Tensor], flip: bool,
               lowres: bool, fp8: bool = False):
    model = Net(PlainPoseNet(cfg, sd, fp8=fp8), next(iter(sd.values())).device)
    pp = PostProcessor(skeleton=skeleton(cfg),
                       cfg=decoder_config(cfg, lowres))

    @torch.no_grad()
    def infer(images: torch.Tensor):
        x = normalize(images, cfg['pixel_mean'], cfg['pixel_std'])
        if flip:
            x = torch.cat([x, torch.flip(x, dims=(2,))])
        return pp.decode_body(model(x), flip_test=flip)

    infer.model, infer.postprocessor = model, pp
    return infer


def _pad(img: np.ndarray, top: int, left: int, h: int, w: int) -> np.ndarray:
    out = np.empty((h, w, 3), np.uint8)
    out[...] = np.asarray(PAD_RGB, np.uint8)
    out[top:top + img.shape[0], left:left + img.shape[1]] = img
    return out


def pad_long_edge(img: np.ndarray, size: int) -> Tuple[np.ndarray, tuple]:
    """A scene whose long edge is `size`, centred on a size x size canvas;
    returns (canvas, (left, top))."""
    h, w = img.shape[:2]
    if max(h, w) != size:
        raise ValueError(f'scene {h}x{w}: long edge is not {size}')
    left, top = (size - w) // 2, (size - h) // 2
    return _pad(img, top, left, size, size), (left, top)


def pad_fixed_height(img: np.ndarray, height: int, h_multiple: int,
                     w_multiple: int) -> Tuple[np.ndarray, tuple]:
    """A scene of height `height`, padded right and down to the multiples;
    returns (canvas, (0, 0))."""
    h, w = img.shape[:2]
    if h != height:
        raise ValueError(f'scene {h}x{w}: height is not {height}')
    return _pad(img, 0, 0, -(-h // h_multiple) * h_multiple,
                -(-w // w_multiple) * w_multiple), (0, 0)


def to_image(poses: np.ndarray, origin: tuple) -> np.ndarray:
    """(M, J, >=3) poses in canvas pixels -> scene pixels."""
    poses = poses.copy()
    poses[:, :, 0] -= origin[0]
    poses[:, :, 1] -= origin[1]
    return poses


def records(poses: np.ndarray, image_id: int) -> List[Dict]:
    """(M, J, 6) poses in scene pixels -> COCO keypoint records, as the
    port's `poses_to_coco_results` writes them (x, y rounded to 2
    decimals, flag 1 where x > 0 or y > 0, score the mean joint score, a
    dummy record where there is none)."""
    out = []
    poses = poses.copy()
    poses[:, :, :2] = np.around(poses[:, :, :2], 2)
    for person in poses:
        if not np.any(person[:, :3]):
            continue
        kps = []
        for x, y, _ in person[:, :3]:
            kps += [float(x), float(y), 1 if (x > 0 or y > 0) else 0]
        out.append({'image_id': image_id, 'category_id': 1, 'keypoints': kps,
                    'score': float(person[:, 2].sum() / len(person))})
    if not out:
        out.append({'image_id': image_id, 'category_id': 1,
                    'keypoints': [0.0] * (poses.shape[1] * 3), 'score': 0.01})
    return out
