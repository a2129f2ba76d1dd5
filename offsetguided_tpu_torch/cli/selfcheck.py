#!/usr/bin/env python
"""Self-contained correctness check of the whole training loop.

Generates a small synthetic COCO dataset (stick figures drawn into the
images), trains a narrow hourglass from scratch, then evaluates it with
the full decoder and the OKS AP metric. A healthy stack reaches AP > 0.7
(AP50 = AP75 = 1.0) within the default 1500 steps.

This exercises every layer end to end: data loading -> augmentation (on
the host by default, on the device with `--device-aug`) -> GT encoding
-> focal-L2/offset losses -> gradients/optimizer -> inference -> decode
(the fused peaks and grouping kernels on the card) -> inverse transforms
-> evaluation.

Port of the JAX package's `cli/selfcheck.py`, with its flags, dataset,
training geometry, model, loss, optimizer, decoder and evaluation
settings, plus `--device` (the card unless told otherwise; on the card
TF32 is off, so the narrow model trains in full fp32 as on the CPU, and
cuDNN takes its deterministic algorithms, so a seed's run repeats) and
`--work-dir`. `make_dataset` draws without OpenCV and writes `.npy`
images (the JAX package draws with cv2 and writes JPEG): the figures
repeat cv2's fixed-point circle (the same pixels) and 3-pixel line (about
one limb in twelve differs by two pixels), and a numpy JPEG round trip
at quality 95 gives the images the compression the JAX package's carry
(within 1.4 grey levels, mean, of its images); the annotations are the
JAX package's, draw for draw from the same `RandomState` stream.

    python -m offsetguided_tpu_torch.cli.selfcheck [--device-aug]

`main` returns the statistics and the trained model; the exit code is 0
when AP >= --min-ap.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time
from typing import Dict

import numpy as np

TEMPLATE = np.array([
    [0.50, 0.07], [0.46, 0.05], [0.54, 0.05], [0.42, 0.07], [0.58, 0.07],
    [0.36, 0.22], [0.64, 0.22], [0.32, 0.40], [0.68, 0.40], [0.30, 0.57],
    [0.70, 0.57], [0.41, 0.54], [0.59, 0.54], [0.40, 0.75], [0.60, 0.75],
    [0.39, 0.95], [0.61, 0.95]], dtype=np.float32)

DRAW_LIMBS = [(5, 6), (5, 7), (6, 8), (11, 12), (5, 11), (6, 12), (11, 13),
              (12, 14), (13, 15), (14, 16), (7, 9), (8, 10)]

SQUARE = 128            # training side and evaluation long edge
BATCH = 4


# cv2's drawing in its 16-bit fixed point, for the self-check's figures:
# filled circles (the same pixels as cv2.circle) and 3-pixel lines (a
# filled quadrilateral with round caps, as cv2.line draws them; its edge
# rasterization rounds differently from cv2's, so about one line in
# twelve gets two pixels more)
_SHIFT = 16
_ONE = 1 << _SHIFT
_HALF = _ONE >> 1


def _tdiv(a: int, b: int) -> int:
    """C integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    h, w = img.shape[:2]
    if 0 <= y < h and max(x1, 0) <= min(x2, w - 1):
        img[y, max(x1, 0):min(x2, w - 1) + 1] = color


def _circle(img: np.ndarray, cx: int, cy: int, r: int, color) -> None:
    """cv2.circle(img, (cx, cy), r, color, -1): midpoint circle, filled by
    horizontal spans."""
    err, dx, dy, plus, minus = 0, r, 0, 1, 2 * r - 1
    while dx >= dy:
        for y, x1, x2 in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx,
                                                        cx + dx),
                          (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy,
                                                        cx + dy)):
            _hline(img, y, x1, x2, color)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _edge(img: np.ndarray, p1, p2, color) -> None:
    """A polygon edge between fixed-point points, pixel by pixel along its
    major axis."""
    h, w = img.shape[:2]
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    major_x = abs(dx) > abs(dy)
    if (dx if major_x else dy) < 0:
        x1, y1, x2, y2 = x2, y2, x1, y1
        dx, dy = -dx, -dy
    if major_x:
        step = _tdiv(dy << _SHIFT, abs(dx) | 1)
        count = (x2 >> _SHIFT) - (x1 >> _SHIFT)
    else:
        step = _tdiv(dx << _SHIFT, abs(dy) | 1)
        count = (y2 >> _SHIFT) - (y1 >> _SHIFT)
    x1 += _HALF
    y1 += _HALF
    pts = [((x2 + _HALF) >> _SHIFT, (y2 + _HALF) >> _SHIFT)]
    for k in range(count + 1):
        pts.append(((x1 >> _SHIFT) + k, (y1 + k * step) >> _SHIFT) if major_x
                   else ((x1 + k * step) >> _SHIFT, (y1 >> _SHIFT) + k))
    for x, y in pts:
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color


def _convex_poly(img: np.ndarray, v, color) -> None:
    """cv2's FillConvexPoly of fixed-point vertices: the edges, then the
    spans between the two edge walkers, row by row."""
    n = len(v)
    h, w = img.shape[:2]
    for i in range(n):
        _edge(img, v[i - 1], v[i], color)
    imin = min(range(n), key=lambda i: (v[i][1], i))
    ymin = (v[imin][1] + _HALF) >> _SHIFT
    ymax = min((max(p[1] for p in v) + _HALF) >> _SHIFT, h - 1)
    walkers = [dict(idx=imin, di=1, x=-_ONE, dx=0, ye=ymin),
               dict(idx=imin, di=n - 1, x=-_ONE, dx=0, ye=ymin)]
    y, edges = ymin, n
    while y <= ymax:
        for e in walkers:
            if y < e['ye']:
                continue
            i0, i1 = e['idx'], (e['idx'] + e['di']) % n
            while edges > 0:
                edges -= 1
                ty = (v[i1][1] + _HALF) >> _SHIFT
                if ty > y:
                    e.update(ye=ty, x=v[i0][0], idx=i1, dx=_tdiv(
                        (v[i1][0] - v[i0][0]) * 2 + (ty - y), 2 * (ty - y)))
                    break
                i0, i1 = i1, (i1 + e['di']) % n
            else:
                edges -= 1
        if edges < 0:
            break
        xl, xr = sorted(e['x'] for e in walkers)
        _hline(img, y, (xl + _HALF) >> _SHIFT, (xr + _HALF) >> _SHIFT, color)
        for e in walkers:
            e['x'] += e['dx']
        y += 1


def _line3(img: np.ndarray, p, q, color) -> None:
    """cv2.line(img, p, q, color, thickness=3): a rectangle 2 pixels to
    either side of the segment and round caps of radius 2."""
    p0 = (int(p[0]) << _SHIFT, int(p[1]) << _SHIFT)
    p1 = (int(q[0]) << _SHIFT, int(q[1]) << _SHIFT)
    dx = (p0[0] - p1[0]) / _ONE
    dy = (p1[1] - p0[1]) / _ONE
    r2 = dx * dx + dy * dy
    if r2 > np.finfo(np.float64).eps:
        r = 2 * _ONE / np.sqrt(r2)      # (3 << 15) + 0.5 * _ONE for odd 3
        ox, oy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _convex_poly(img, [(p0[0] + ox, p0[1] + oy), (p0[0] - ox, p0[1] - oy),
                           (p1[0] - ox, p1[1] - oy), (p1[0] + ox, p1[1] + oy)],
                     color)
    for c in (p0, p1):
        _circle(img, (c[0] + _HALF) >> _SHIFT, (c[1] + _HALF) >> _SHIFT, 2,
                color)


# JPEG at cv2's default quality 95 with 4:2:0 chroma (what the JAX
# package's images go through), as a numpy round trip: JFIF YCbCr, 2x2
# chroma averages, 8x8 DCTs quantized by the standard tables at quality
# 95, libjpeg's "fancy" chroma upsampling. Within 1.4 grey levels (mean)
# of libjpeg's result on the self-check images.
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103,
    99], np.float64).reshape(8, 8)
_Q_CHROMA = np.full((8, 8), 99.0)
_Q_CHROMA[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99],
                     [47, 66, 99, 99]]
_K = np.arange(8)
_DCT = np.sqrt(2 / 8) * np.cos((2 * _K[None, :] + 1) * _K[:, None]
                               * np.pi / 16)
_DCT[0] /= np.sqrt(2)


def _quantized(plane: np.ndarray, table: np.ndarray,
               quality: int) -> np.ndarray:
    """One plane through 8x8 DCT, quantization at `quality` and back."""
    q = np.clip(np.floor((table * (200 - 2 * quality) + 50) / 100), 1, 255)
    h, w = plane.shape
    hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
    x = np.pad(plane, ((0, hp - h), (0, wp - w)), mode='edge') - 128.0
    blocks = x.reshape(hp // 8, 8, wp // 8, 8).transpose(0, 2, 1, 3)
    c = np.round(_DCT @ blocks @ _DCT.T / q) * q
    x = (_DCT.T @ c @ _DCT).transpose(0, 2, 1, 3).reshape(hp, wp)
    return x[:h, :w] + 128.0


def _jpeg_like(rgb: np.ndarray, quality: int = 95) -> np.ndarray:
    """uint8 RGB (even sides) -> its JPEG round trip, approximately."""
    x = rgb.astype(np.float64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = _quantized(0.299 * r + 0.587 * g + 0.114 * b, _Q_LUMA, quality)
    chroma = []
    for c in (-0.168736 * r - 0.331264 * g + 0.5 * b + 128,
              0.5 * r - 0.418688 * g - 0.081312 * b + 128):
        h, w = c.shape
        c = c.reshape(h // 2, 2, w // 2, 2).mean((1, 3))
        c = _quantized(c, _Q_CHROMA, quality)
        p = np.pad(c, 1, mode='edge')
        up = np.empty((h, w))
        for dy in (0, 1):
            for dx in (0, 1):
                vert = p[2 * dy:2 * dy + h // 2, 1:-1]
                horz = p[1:-1, 2 * dx:2 * dx + w // 2]
                diag = p[2 * dy:2 * dy + h // 2, 2 * dx:2 * dx + w // 2]
                up[dy::2, dx::2] = (9 * c + 3 * vert + 3 * horz + diag) / 16
        chroma.append(up - 128.0)
    cb, cr = chroma
    out = np.stack([y + 1.402 * cr, y - 0.344136 * cb - 0.714136 * cr,
                    y + 1.772 * cb], axis=-1)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def make_dataset(root: pathlib.Path, n_images: int = 4):
    """Write `n_images` 320x256 stick-figure images (`.npy`, uint8 RGB) and
    their COCO annotations under `root`; returns (image dir, annotation
    file)."""
    root = pathlib.Path(root)
    (root / 'images').mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(3)
    images, annotations = [], []
    ann_id = 1
    for img_id in range(1, n_images + 1):
        h, w = 256, 320
        img = (rng.rand(h, w, 3) * 80 + 60).astype(np.uint8)
        for p in range(1 + img_id % 2):
            box = 130 + rng.rand() * 60
            x0 = 10 + p * 150 + rng.rand() * 10
            y0 = 10 + rng.rand() * 30
            kps = np.zeros((17, 3), np.float32)
            kps[:, 0] = x0 + TEMPLATE[:, 0] * box + rng.rand(17) * 0.7
            kps[:, 1] = y0 + TEMPLATE[:, 1] * box + rng.rand(17) * 0.7
            kps[:, 2] = 2
            pts = kps[:, :2].astype(int)
            for a, b in DRAW_LIMBS:
                _line3(img, pts[a], pts[b], (220, 40, 40))
            for j in range(17):
                _circle(img, pts[j, 0], pts[j, 1], 4, (40, 220, 40))
                _circle(img, pts[j, 0], pts[j, 1], 2,
                        (40 + j * 10, 120, 250 - j * 10))
            bw = kps[:, 0].max() - kps[:, 0].min() + 6
            bh = kps[:, 1].max() - kps[:, 1].min() + 6
            bx, by = kps[:, 0].min() - 3, kps[:, 1].min() - 3
            annotations.append({
                'id': ann_id, 'image_id': img_id, 'category_id': 1,
                'keypoints': kps.reshape(-1).tolist(), 'num_keypoints': 17,
                'iscrowd': 0, 'bbox': [float(bx), float(by), float(bw),
                                       float(bh)],
                'area': float(bw * bh * 0.6),
                'segmentation': [[float(bx), float(by), float(bx + bw),
                                  float(by), float(bx + bw), float(by + bh),
                                  float(bx), float(by + bh)]],
            })
            ann_id += 1
        name = f'{img_id:06d}.npy'
        # the colors above are cv2's BGR: the JAX package's reader gives
        # the channels reversed, after the JPEG round trip
        np.save(root / 'images' / name, _jpeg_like(img[:, :, ::-1]))
        images.append({'id': img_id, 'file_name': name, 'height': h,
                       'width': w})
    (root / 'annotations.json').write_text(json.dumps(
        {'images': images, 'annotations': annotations,
         'categories': [{'id': 1, 'name': 'person'}]}))
    return str(root / 'images'), str(root / 'annotations.json')


def configs():
    """The self-check's model, encoder, augmentation, loss, decoder and
    evaluation configurations (the JAX package's)."""
    from ..config.defaults import (AugmentationConfig, DecoderConfig,
                                   EncoderConfig, EvalConfig, HeadsConfig,
                                   LossConfig, ModelConfig)
    return dict(
        model=ModelConfig(n_stacks=1, hg_order=3, dims=(48, 48, 64, 96),
                          modules=(1, 1, 1, 1), cnv_dim=48,
                          compute_dtype='float32', heads=HeadsConfig()),
        encoder=EncoderConfig(max_persons=8),
        # deterministic training geometry matched to eval (long edge
        # 128 of 320)
        aug=AugmentationConfig(square_length=SQUARE, flip_prob=0.0,
                               max_rotate=0.0, min_scale=0.4, max_scale=0.4,
                               min_stretch=1.0, max_stretch=1.0,
                               max_translate=0, gray_prob=0.0,
                               color_tint_prob=0.0,
                               annotation_jitter_prob=0.0),
        loss=LossConfig(stack_weights=(1.0,), fgamma=2.0,
                        lambdas=(1.0, 0.1, 100.0, 300.0, 1.0)),
        decoder=DecoderConfig(topk=8, thre_hmp=0.05, dist_max=25.0,
                              use_scale=True, person_thre=0.03, max_poses=8),
        eval=EvalConfig(long_edge=SQUARE, flip_test=False, batch_size=2),
    )


def main(argv=None) -> Dict:
    """Trains and evaluates; returns `stats` (the OKS metrics), `passed`
    (AP >= --min-ap), `steps`, `train_s` (the training loop's seconds),
    `history` (the losses every 250 steps), `model` (the trained model,
    prepared for inference), `state_dict` (its trained weights before
    BatchNorm folding, on the CPU), `postprocessor`, `model_cfg`,
    `eval_cfg`, `image_dir`, `annotations`, `results` (the COCO records)
    and `device`."""
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--steps', type=int, default=1500)
    p.add_argument('--time-budget-s', type=float, default=1800)
    p.add_argument('--min-ap', type=float, default=0.5)
    p.add_argument('--device-aug', action='store_true',
                   help='train through the device-side augmentation '
                        '(ops/augment.py) instead of the host warp')
    p.add_argument('--opt-state-dtype', default='float32',
                   choices=['float32', 'bfloat16'],
                   help='Adam moment-state dtype')
    p.add_argument('--seed', type=int, default=0,
                   help='model-init + batch-order seed (the dataset stays '
                        'fixed, so every seed trains the same task)')
    p.add_argument('--device', default=None,
                   help='torch device; default the CUDA card')
    p.add_argument('--work-dir', default=None,
                   help='where the dataset is written (default: a fresh '
                        'temporary directory)')
    args = p.parse_args(argv)
    from ..device import exact_fp32
    with exact_fp32():
        return run(args)


def run(args) -> Dict:
    """`main` after parsing, under the caller's numeric settings."""
    import torch
    from ..config.defaults import SkeletonConfig, TrainConfig
    from ..data.coco import CocoJson
    from ..data.pipeline import CocoKeypoints, batch_iterator
    from ..decoder import PostProcessor
    from ..device import resolve_device
    from ..eval.cocoeval import evaluate_coco_keypoints
    from ..eval.harness import run_images
    from ..models import PoseNet
    from ..models.network import init_reference_
    from ..parallel.train_step import TrainStep, make_optimizer
    from .train import device_batch

    dev = resolve_device(args.device)
    root = pathlib.Path(args.work_dir or tempfile.mkdtemp(
        prefix='selfcheck_'))
    img_dir, ann_file = make_dataset(root)
    cfg = configs()
    skeleton = SkeletonConfig()
    ds = CocoKeypoints(img_dir, ann_file, skeleton=skeleton, aug=cfg['aug'],
                       square_length=SQUARE, max_persons=8,
                       device_aug=args.device_aug, raw_canvas=320)
    model = init_reference_(PoseNet(cfg['model']),
                            torch.Generator().manual_seed(args.seed))
    model = model.to(dev)
    optimizer = make_optimizer(
        TrainConfig(learning_rate=2e-3, opt_state_dtype=args.opt_state_dtype),
        model.parameters())
    step = TrainStep(model, optimizer, cfg['loss'])

    history = []
    t0 = time.time()
    n = 0
    it = batch_iterator(ds, BATCH, seed=args.seed, shuffle=False,
                        epochs=None)
    try:
        for batch in it:
            m = step(*device_batch(batch, ds, dev, cfg['encoder'], skeleton,
                                   SQUARE))
            n += 1
            if n % 250 == 0:
                rec = dict(step=n, total=float(m['total']),
                           hmp=float(m['hmp']))
                history.append(rec)
                print(f'step {n}: total={rec["total"]:.3f} '
                      f'hmp={rec["hmp"]:.4f}', flush=True)
            if n >= args.steps or time.time() - t0 > args.time_budget_s:
                break
    finally:
        it.close()
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    train_s = time.time() - t0

    state_dict = {k: v.detach().cpu().clone()
                  for k, v in model.state_dict().items()}
    model.prepare_inference()
    pp = PostProcessor(cfg=cfg['decoder'])
    coco = CocoJson(ann_file)
    results = run_images(model, pp, coco, img_dir, cfg['eval'])
    stats = evaluate_coco_keypoints(coco, results, skeleton.sigmas)
    print('self-check metrics:', {k: round(v, 3) for k, v in stats.items()})
    ok = stats['AP'] >= args.min_ap
    print('SELF-CHECK', 'PASSED' if ok else 'FAILED',
          f'(AP={stats["AP"]:.3f}, threshold {args.min_ap}, {n} steps, '
          f'{train_s:.1f} s, {dev})', flush=True)
    return dict(stats=stats, passed=ok, steps=n, train_s=train_s,
                history=history, model=model, state_dict=state_dict,
                postprocessor=pp, model_cfg=cfg['model'],
                eval_cfg=cfg['eval'], image_dir=img_dir,
                annotations=ann_file, results=results, device=str(dev))


if __name__ == '__main__':
    sys.exit(0 if main()['passed'] else 1)
