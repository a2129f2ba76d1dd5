#!/usr/bin/env python
"""Device-augmentation warp benchmark: patch gather against tiled matmuls.

Port of the JAX package's `cli/bench_warp.py` with its flags, plus
`--device` (the card unless told otherwise). It times the two bicubic
affine formulations of `ops/augment.py` (`affine_sample`, the 4x4
footprint gather, and `affine_sample_tiled`, windowed banded matmuls) on
seeded data already on the device, at the device-aug shape (batch x raw
canvas -> square, RGB + mask packed into 4 channels), with random
inverse matrices of the training augmentation's range (rotation up to 45
degrees, scale 0.5-2) and cropped valid sizes. Prints ms a batch for each
and the largest and mean |patch - tiled|; with `--full` also the whole
`augment_batch` (warp, photometric, annotation transform) under each.
Times are CUDA events on the card (`utils/profiling.py::device_time`).

    python -m offsetguided_tpu_torch.cli.bench_warp [--full]
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

# the JAX package's tolerance between the two warps (tests/test_device_aug.py)
RTOL, ATOL = 1e-3, 0.05


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--batch-size', type=int, default=16)
    p.add_argument('--raw-canvas', type=int, default=640)
    p.add_argument('--square-length', type=int, default=512)
    p.add_argument('--slope-bound', type=float, default=3.0)
    p.add_argument('--lane-chunk', type=int, default=64)
    p.add_argument('--row-tile', type=int, default=8)
    p.add_argument('--impls', default='patch,tiled')
    p.add_argument('--full', action='store_true',
                   help='also time augment_batch (warp+photometric+anns)')
    p.add_argument('--device', default=None,
                   help='torch device (default: the card)')
    args = p.parse_args(argv)

    from ..config.defaults import SkeletonConfig
    from ..data.transforms import PAD_RGB
    from ..device import resolve_device
    from ..ops.augment import affine_sample, affine_sample_tiled, augment_batch
    from ..utils.profiling import device_time

    dev = resolve_device(args.device)
    rng = np.random.RandomState(0)
    n, c0, s = args.batch_size, args.raw_canvas, args.square_length
    imgs = torch.from_numpy(
        rng.randint(0, 256, (n, c0, c0, 4), dtype=np.uint8)).to(dev)
    mats = []
    for _ in range(n):
        th = rng.uniform(-np.pi / 4, np.pi / 4)
        sc = rng.uniform(0.5, 2.0)
        f = rng.uniform(0.95, 1.05)
        fwd = np.array([[np.cos(th) * sc * f, -np.sin(th) * sc],
                        [np.sin(th) * sc * f, np.cos(th) * sc]])
        t = rng.uniform(-40, 40, 2)
        mats.append(np.hstack([np.linalg.inv(fwd), t[:, None]]))
    mats = torch.from_numpy(np.stack(mats).astype(np.float32)).to(dev)
    valid = torch.from_numpy(
        rng.randint(c0 // 2, c0 + 1, (n, 2)).astype(np.int32)).to(dev)
    border = torch.tensor(tuple(PAD_RGB) + (255.0,), device=dev)

    impls = args.impls.split(',')
    fns = {}
    if 'patch' in impls:
        fns['patch'] = lambda im, m, v: affine_sample(im, m, (s, s), border, v)
    if 'tiled' in impls:
        fns['tiled'] = lambda im, m, v: affine_sample_tiled(
            im, m, (s, s), border, v, slope_bound=args.slope_bound,
            row_tile=args.row_tile, lane_chunk=args.lane_chunk)

    result = {'warp_ms': {}, 'mpix_per_s': {}, 'augment_batch_ms': {},
              'device': (torch.cuda.get_device_name(dev)
                         if dev.type == 'cuda' else str(dev))}
    outs = {}
    with torch.no_grad():
        for name, fn in fns.items():
            outs[name] = fn(imgs, mats, valid)
            dt = device_time(fn, imgs, mats, valid)
            result['warp_ms'][name] = dt * 1e3
            result['mpix_per_s'][name] = n * s * s / dt / 1e6
            print(f'warp[{name}]: {dt * 1e3:.1f} ms/batch '
                  f'({n * s * s / dt / 1e6:.1f} Mpix/s)')
        if len(outs) == 2:
            d = (outs['patch'] - outs['tiled']).abs()
            result['max_abs_diff'] = float(d.max())
            result['mean_abs_diff'] = float(d.mean())
            result['within_tolerance'] = bool(
                (d <= ATOL + RTOL * outs['patch'].abs()).all())
            print(f'  |patch - tiled|: max {result["max_abs_diff"]:.4f} '
                  f'mean {result["mean_abs_diff"]:.6f} (within rtol {RTOL} '
                  f'atol {ATOL}: {result["within_tolerance"]})')
        del outs

        if args.full:
            sk = SkeletonConfig()
            left = [i for i, nm in enumerate(sk.keypoints)
                    if nm.startswith('left')]
            right = [i for i, nm in enumerate(sk.keypoints)
                     if nm.startswith('right')]
            t = lambda a: torch.from_numpy(a).to(dev)
            anns = t(rng.rand(n, 8, sk.n_keypoints, 4).astype(np.float32))
            fmats = t(rng.rand(n, 3, 3).astype(np.float32))
            sxy = torch.ones((n, 2), device=dev)
            flips = torch.zeros((n,), dtype=torch.bool, device=dev)
            grays = torch.zeros((n,), dtype=torch.bool, device=dev)
            tints = t(rng.rand(n, 4).astype(np.float32))
            for name in impls:
                def fn(im, mi, name=name):
                    return augment_batch(
                        im[..., :3], im[..., 3], anns, fmats, mi, sxy, flips,
                        grays, tints, valid, s, left, right, warp_impl=name,
                        slope_bound=args.slope_bound)
                dt = device_time(fn, imgs, mats)
                result['augment_batch_ms'][name] = dt * 1e3
                print(f'augment_batch[{name}]: {dt * 1e3:.1f} ms/batch')
    return result


if __name__ == '__main__':
    main()
