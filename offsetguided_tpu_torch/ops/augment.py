"""Device-side training augmentation: batched affine warp + photometric.

The host keeps only what it must (image read, mask render and all the
randomness: every parameter is sampled on the host, `data/pipeline.py`),
and the pixel work runs on the device, batched:

- `affine_sample`: 16-tap bicubic (A = -0.75, cv2 INTER_CUBIC's kernel)
  warp with cv2 BORDER_CONSTANT semantics, as one gather of the 4x4 source
  footprint of every output pixel and the separable weights applied to it;
  per-sample valid (h, w) bounds keep the fixed raw canvas's padding out of
  the borders.
- `transform_annotations`: the same 3x3 matrix applied to keypoints, with
  per-sample left/right channel swap under flip and off-canvas
  invalidation.
- `photometric`: cv2-weight grayscale and HSV tint, with the shifts
  sampled on the host and shipped as per-sample scalars.

Same functions and contracts as the JAX package's `ops/augment.py`, whose
`affine_sample` this is; its `affine_sample_tiled` (the same warp as banded
matmuls for the TPU's matrix unit) is not ported.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..data.transforms import PAD_RGB


def _cubic_w(d: torch.Tensor) -> torch.Tensor:
    """Cubic convolution weights, a = -0.75."""
    a = -0.75
    d = d.abs()
    near = (a + 2.0) * d ** 3 - (a + 3.0) * d ** 2 + 1.0
    far = a * d ** 3 - 5.0 * a * d ** 2 + 8.0 * a * d - 4.0 * a
    return torch.where(d <= 1.0, near,
                       torch.where(d < 2.0, far, torch.zeros_like(d)))


def affine_sample(images: torch.Tensor, mats_dst2src: torch.Tensor,
                  out_hw: Tuple[int, int], border_value,
                  valid_hw: torch.Tensor | None = None,
                  row_chunk: int = 64) -> torch.Tensor:
    """Batched bicubic affine sampling (cv2.warpAffine INTER_CUBIC +
    BORDER_CONSTANT equivalent), float32 (N, oh, ow, C).

    images: (N, H, W, C) uint8 or float, H and W at least 4; mats_dst2src:
    (N, 2, 3) mapping OUTPUT pixel coords to source coords (the inverse of
    the forward matrix). border_value: scalar or (C,). valid_hw: (N, 2)
    int, the actual (h, w) of each sample inside the canvas; taps outside
    it read the border constant.

    Each output pixel gathers the 4x4 patch that starts one cell before its
    source cell, clipped into the image; the weights come from the clipped
    patch's actual rows and columns, taps outside valid_hw weigh 0 and the
    border color takes `1 - sum(weights)` (the Keys kernel is a partition
    of unity). Output rows go in `row_chunk` slabs to bound the patch
    tensor."""
    n, h, w, c = images.shape
    oh, ow = out_hw
    if h < 4 or w < 4:
        raise ValueError(f'affine_sample needs a source of at least 4x4, '
                         f'got {h}x{w}')
    dev = images.device
    if valid_hw is None:
        valid_hw = torch.tensor([[h, w]] * n, dtype=torch.int32, device=dev)
    vh = valid_hw[:, 0].float()[:, None, None]
    vw = valid_hw[:, 1].float()[:, None, None]
    m = mats_dst2src.float()
    border = torch.as_tensor(border_value, dtype=torch.float32,
                             device=dev).reshape(-1).expand(c)
    flat = images.reshape(n, h * w, c)
    taps = torch.arange(4, dtype=torch.float32, device=dev)
    itaps = torch.arange(4, device=dev)
    out = torch.empty((n, oh, ow, c), dtype=torch.float32, device=dev)
    xs = torch.arange(ow, dtype=torch.float32, device=dev)[None, None, :]
    for y0 in range(0, oh, row_chunk):
        rows = min(row_chunk, oh - y0)
        ys = torch.arange(y0, y0 + rows, dtype=torch.float32,
                          device=dev)[None, :, None]
        sx = (m[:, 0, 0, None, None] * xs + m[:, 0, 1, None, None] * ys
              + m[:, 0, 2, None, None]).reshape(n, -1)
        sy = (m[:, 1, 0, None, None] * xs + m[:, 1, 1, None, None] * ys
              + m[:, 1, 2, None, None]).reshape(n, -1)
        sy0 = (torch.floor(sy) - 1.0).clamp(0.0, float(h - 4))
        sx0 = (torch.floor(sx) - 1.0).clamp(0.0, float(w - 4))
        ry = sy0[..., None] + taps                                # (n, P, 4)
        rx = sx0[..., None] + taps
        wy = _cubic_w(sy[..., None] - ry) * ((ry >= 0) & (ry < vh))
        wx = _cubic_w(sx[..., None] - rx) * ((rx >= 0) & (rx < vw))
        idx = ((sy0.long()[..., None, None] + itaps[:, None]) * w
               + sx0.long()[..., None, None] + itaps)             # (n, P, 4, 4)
        p = idx.shape[1]
        patches = flat.gather(1, idx.reshape(n, p * 16, 1).expand(-1, -1, c))
        patches = patches.reshape(n, p, 4, 4, c).float()
        val = torch.einsum('npabc,npa,npb->npc', patches, wy, wx)
        covered = wy.sum(-1) * wx.sum(-1)
        val = val + border * (1.0 - covered)[..., None]
        out[:, y0:y0 + rows] = val.reshape(n, rows, ow, c)
    return out


def warp_slope_bound(aug_cfg) -> float:
    """Bound on |dst->src linear coefficients| for an `AugmentationConfig`:
    the inverse of rotate(theta) @ scale(s) @ stretch(f) has entries at
    most (|cos| + |sin|) / (s f) <= sqrt(2) / (min_scale * min_stretch)
    (what the JAX package's tiled warp sizes its source windows by)."""
    return float(np.sqrt(2.0)
                 / (aug_cfg.min_scale * min(aug_cfg.min_stretch, 1.0)))


def transform_annotations(anns: torch.Tensor, mats: torch.Tensor,
                          scale_xy: torch.Tensor, flips: torch.Tensor,
                          left_index: Sequence[int],
                          right_index: Sequence[int],
                          out_size: int) -> torch.Tensor:
    """Forward affine on keypoints: xy' = M @ [x, y, 1], per-keypoint scale
    *= sqrt(sx * sy), left/right channel swap under flip, off-canvas
    invalidation; all-zero (padding) person rows stay zero.

    anns: (N, P, J, 4) [x, y, v, scale]; mats: (N, 3, 3) forward
    (src->dst); scale_xy: (N, 2); flips: (N,) bool."""
    m = mats.float()
    x, y = anns[..., 0], anns[..., 1]
    nx = (m[:, 0, 0, None, None] * x + m[:, 0, 1, None, None] * y
          + m[:, 0, 2, None, None])
    ny = (m[:, 1, 0, None, None] * x + m[:, 1, 1, None, None] * y
          + m[:, 1, 2, None, None])
    ks = anns[..., 3] * torch.sqrt(scale_xy[:, 0] * scale_xy[:, 1])[:, None,
                                                                    None]
    out = torch.stack([nx, ny, anns[..., 2], ks], dim=-1)

    perm = np.arange(out.shape[2])
    perm[list(left_index)] = list(right_index)
    perm[list(right_index)] = list(left_index)
    swapped = out[:, :, torch.as_tensor(perm, device=out.device)]
    out = torch.where(flips[:, None, None, None], swapped, out)

    off = ((out[..., 0] <= 0) | (out[..., 1] <= 0)
           | (out[..., 0] > out_size) | (out[..., 1] > out_size))
    vis = torch.where(off, torch.zeros_like(out[..., 2]), out[..., 2])
    out = torch.cat([out[..., :2], vis[..., None], out[..., 3:]], dim=-1)
    padding = (anns == 0).all(dim=3).all(dim=2)
    return torch.where(padding[:, :, None, None], torch.zeros_like(out), out)


def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """float RGB [0,255] -> (H in [0,360), S in [0,1], V in [0,255])."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    one = torch.ones_like(d)
    zero = torch.zeros_like(d)
    safe = torch.where(d == 0, one, d)
    h = torch.where(mx == r, (g - b) / safe,
                    torch.where(mx == g, 2.0 + (b - r) / safe,
                                4.0 + (r - g) / safe))
    h = torch.remainder(torch.where(d == 0, zero, h * 60.0), 360.0)
    s = torch.where(mx == 0, zero, d / torch.where(mx == 0, one, mx))
    return torch.stack([h, s, mx], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    hh = torch.remainder(h, 360.0) / 60.0
    i = torch.floor(hh)
    f = hh - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*vals):
        out = vals[-1]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def photometric(images: torch.Tensor, grays: torch.Tensor,
                tints: torch.Tensor) -> torch.Tensor:
    """Grayscale, then HSV tint. images: (N, H, W, 3) float [0,255];
    grays: (N,) bool; tints: (N, 4) float [apply (0/1), dh, ds, dv] in cv2
    channel units (H in half-degrees, S and V in 0..255)."""
    y = (0.299 * images[..., 0] + 0.587 * images[..., 1]
         + 0.114 * images[..., 2])
    gray_img = y[..., None].expand_as(images)
    images = torch.where(grays[:, None, None, None], gray_img, images)

    hsv = _rgb_to_hsv(images)
    h = torch.remainder(hsv[..., 0] + tints[:, 1, None, None] * 2.0, 360.0)
    s = (hsv[..., 1] + tints[:, 2, None, None] / 255.0).clamp(0.0, 1.0)
    v = (hsv[..., 2] + tints[:, 3, None, None]).clamp(0.0, 255.0)
    tinted = _hsv_to_rgb(torch.stack([h, s, v], dim=-1))
    apply = tints[:, 0, None, None, None] > 0.5
    return torch.where(apply, tinted, images)


def augment_batch(raw_images: torch.Tensor, raw_masks: torch.Tensor,
                  anns: torch.Tensor, mats: torch.Tensor,
                  mats_inv: torch.Tensor, scale_xy: torch.Tensor,
                  flips: torch.Tensor, grays: torch.Tensor,
                  tints: torch.Tensor, valid_hw: torch.Tensor, out_size: int,
                  left_index: Sequence[int], right_index: Sequence[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Warp + photometric + annotation transform.

    raw_images: (N, C0, C0, 3) uint8 raw canvas (top-left anchored);
    raw_masks: (N, C0, C0) uint8 0/255 mask_miss at source resolution.
    Returns (images (N, S, S, 3) uint8, mask (N, S, S) float [0, 1],
    anns (N, P, J, 4)). The image and the mask go through ONE 4-channel
    warp (they share every coordinate, weight and gather); the border is
    PAD_RGB for the image and 255 for the mask."""
    packed = torch.cat([raw_images, raw_masks[..., None].to(raw_images.dtype)],
                       dim=-1)
    border = torch.tensor(tuple(PAD_RGB) + (255.0,), dtype=torch.float32,
                          device=packed.device)
    warped = affine_sample(packed, mats_inv, (out_size, out_size), border,
                           valid_hw)
    imgs = photometric(warped[..., :3], grays, tints)
    imgs = imgs.round().clamp(0, 255).to(torch.uint8)
    mask = (warped[..., 3] / 255.0).clamp(0.0, 1.0)
    anns = transform_annotations(anns, mats, scale_xy, flips, left_index,
                                 right_index, out_size)
    return imgs, mask, anns


def augment_batch_dict(batch, out_size: int, left_index: Sequence[int],
                       right_index: Sequence[int]):
    """`augment_batch` over the batch dict the data pipeline ships (its
    `sample_spec` keys, as tensors on the device)."""
    return augment_batch(
        batch['image'], batch['mask_miss'], batch['anns'],
        batch['aug_mat'], batch['aug_mat_inv'], batch['aug_scale_xy'],
        batch['aug_flags'][:, 0] > 0.5, batch['aug_flags'][:, 1] > 0.5,
        batch['aug_tint'], batch['valid_hw'], out_size,
        left_index, right_index)
