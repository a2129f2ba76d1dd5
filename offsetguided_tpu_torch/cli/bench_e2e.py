#!/usr/bin/env python
"""From-disk end-to-end evaluation throughput on the hard synthetic set.

Port of the JAX package's `cli/bench_e2e.py`. Unlike `cli/bench.py`
(device only, one resident batch), this measures the whole harness the
way a user runs it: JPEG decode (the port's codec) -> rescale / pad ->
device forward (+ optional flip test) -> on-device decode -> inverse
transform -> COCO records, with `--io-workers` host threads feeding the
device loop (`eval/harness.py::run_images`). The hard set is written
under `--data-root` as painted JPEGs (quality 95, 4:2:0) unless its
annotation file is there already; without `--data-root` it goes to a
temporary directory that is removed afterwards.

Each mode runs twice: a cold pass (cuDNN's first calls, the page cache)
and the timed pass. `--fixed-height` measures the fixed-height mode
(height rescaled to `--long-edge`, width padded to `--width-bucket`
multiples) and reports the distinct padded shapes. The weights are
`random_posenet(seed=0)`, BatchNorm calibrated at `--long-edge`. The JAX
version's `--no-cache` (its persistent XLA compile cache) has no
counterpart and is left out.

    python -m offsetguided_tpu_torch.cli.bench_e2e [--modes noflip,flip]

Prints one JSON line per configuration.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--data-root', default=None,
                   help='hard-set location (written if absent; default: a '
                        'temporary directory)')
    p.add_argument('--n-images', type=int, default=100)
    p.add_argument('--long-edge', type=int, default=640)
    p.add_argument('--batch-size', type=int, default=8)
    p.add_argument('--io-workers', type=int, default=4)
    p.add_argument('--modes', default='noflip,flip',
                   help='comma list from {noflip, flip}')
    p.add_argument('--fixed-height', action='store_true',
                   help='the fixed-height eval mode: height rescaled to '
                        '--long-edge, width padded to --width-bucket '
                        'multiples; also reports the distinct padded shapes')
    p.add_argument('--width-bucket', type=int, default=256,
                   help='fixed-height width padding bucket (a multiple of '
                        'the max stride 128)')
    p.add_argument('--debug-tiny-model', action='store_true')
    p.add_argument('--device', default=None,
                   help='torch device (default: the card)')
    return p.parse_args(argv)


def main(argv=None) -> list:
    args = cli(argv)
    import torch

    from ..config.defaults import DecoderConfig, EvalConfig, SkeletonConfig
    from ..data.coco import CocoJson
    from ..data.synthetic import make_hard_dataset
    from ..decoder import PostProcessor
    from ..device import resolve_device
    from ..eval.harness import preprocess_eval, run_images
    from ..models import random_posenet
    from .serve import model_config

    dev = resolve_device(args.device)
    tmp = None
    root = args.data_root
    if root is None:
        root = tmp = tempfile.mkdtemp(prefix='bench_e2e_')
    try:
        ann_file = os.path.join(root, 'annotations.json')
        img_dir = os.path.join(root, 'images')
        if not os.path.exists(ann_file):
            img_dir, ann_file = make_hard_dataset(root, args.n_images,
                                                  ext='jpg')
        skeleton = SkeletonConfig()
        model = random_posenet(model_config(args), 0, device=dev,
                               calib_size=args.long_edge).prepare_inference()
        pp = PostProcessor(cfg=DecoderConfig(topk=32, thre_hmp=0.04,
                                             dist_max=40.0))
        coco = CocoJson(ann_file)
        ids = coco.image_ids(with_persons=True)[:args.n_images]
        lines = []
        for mode in args.modes.split(','):
            flip = mode.strip() == 'flip'
            cfg = EvalConfig(long_edge=args.long_edge, flip_test=flip,
                             batch_size=args.batch_size,
                             io_workers=args.io_workers,
                             fixed_height=args.fixed_height,
                             width_bucket=args.width_bucket)
            extra = {}
            if args.fixed_height:
                # the padded (H, W) of each image, from the annotation
                # file's sizes without decoding pixels
                shapes = set()
                for i in ids:
                    info = coco.image_info(i)
                    dummy = np.zeros((info['height'], info['width'], 3),
                                     np.uint8)
                    shapes.add(preprocess_eval(
                        dummy, np.zeros((0, skeleton.n_keypoints, 4),
                                        np.float32), cfg,
                        skeleton.n_keypoints)[0].shape[:2])
                extra = {'n_padded_shapes': len(shapes),
                         'shapes': sorted(map(list, shapes)),
                         'width_bucket': args.width_bucket}
            passes = []
            for _ in range(2):              # cold, then timed
                if dev.type == 'cuda':
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                results = run_images(model, pp, coco, img_dir, cfg,
                                     n_images=args.n_images,
                                     skeleton=skeleton)
                if dev.type == 'cuda':
                    torch.cuda.synchronize(dev)
                passes.append(time.perf_counter() - t0)
            line = {
                'metric': (f'fromdisk_fps_{"fh" if args.fixed_height else ""}'
                           f'{args.long_edge}{"_flip" if flip else ""}'),
                'value': round(len(ids) / passes[1], 2),
                'unit': 'img/s',
                'cold_pass_s': round(passes[0], 1),
                'n_images': len(ids),
                'n_results': len(results),
                'io_workers': args.io_workers,
                'batch_size': args.batch_size,
                **extra,
            }
            print(json.dumps(line), flush=True)
            lines.append(line)
        return lines
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == '__main__':
    main()
