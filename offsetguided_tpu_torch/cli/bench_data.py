#!/usr/bin/env python
"""Data pipeline throughput: the host loader and the device feed.

Port of the JAX package's `cli/bench_data.py`. The loader (one thread, or
`--num-workers` processes) reads images, renders masks and, on the host
route, warps and tints them; the feed (`cli/train.py::device_batch`)
copies the batch to the device and encodes the targets there (after the
warp, with `--device-aug`). One JSON line:

- `loader_ms`: mean time the consumer waited for a batch;
- `interval_ms`: mean wall time per batch, loader and feed overlapped
  (`samples_per_s` is the batch size over it);
- `feed_ms`: mean feed time per batch (CUDA events on the card, the host
  clock around a finished feed on the CPU);
- `first_batch_s`: the first batch's wait (worker start-up included),
  left out of the means.

    python -m offsetguided_tpu_torch.cli.bench_data --image-dir images \\
        --annotation-file ann.json [--num-workers 4] [--device-aug]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict


def main(argv=None) -> Dict:
    """Runs the benchmark; prints and returns the JSON record."""
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--image-dir', required=True)
    p.add_argument('--annotation-file', required=True)
    p.add_argument('--square-length', type=int, default=512)
    p.add_argument('--batch-size', type=int, default=16)
    p.add_argument('--n-batches', type=int, default=20)
    p.add_argument('--num-workers', type=int, default=0,
                   help='loader processes (0 = one background thread)')
    p.add_argument('--device-aug', action='store_true',
                   help='the device-aug host path (image read, mask render '
                        'and parameter sampling; the warp runs on the '
                        'device)')
    p.add_argument('--raw-canvas', type=int, default=640)
    p.add_argument('--device', default=None,
                   help='torch device; default the CUDA card')
    args = p.parse_args(argv)

    import torch
    from ..config.defaults import (AugmentationConfig, EncoderConfig,
                                   SkeletonConfig)
    from ..data.pipeline import CocoKeypoints, batch_iterator
    from ..device import resolve_device
    from .train import device_batch

    dev = resolve_device(args.device)
    cuda = dev.type == 'cuda'
    skeleton = SkeletonConfig()
    enc = EncoderConfig()
    ds = CocoKeypoints(args.image_dir, args.annotation_file,
                       skeleton=skeleton,
                       aug=AugmentationConfig(
                           square_length=args.square_length),
                       square_length=args.square_length,
                       device_aug=args.device_aug,
                       raw_canvas=args.raw_canvas)

    waits, feeds, spans = [], [], []
    it = batch_iterator(ds, args.batch_size, epochs=None,
                        num_workers=args.num_workers)
    try:
        t_start = last = time.perf_counter()
        t_first = None
        for i in range(args.n_batches + 1):
            batch = next(it)
            now = time.perf_counter()
            waits.append(now - last)
            if i == 0:
                t_first = now
            if cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = device_batch(batch, ds, dev, enc, skeleton,
                                   args.square_length)
                e1.record()
                spans.append((e0, e1))
            else:
                t0 = time.perf_counter()
                out = device_batch(batch, ds, dev, enc, skeleton,
                                   args.square_length)
                feeds.append((time.perf_counter() - t0) * 1e3)
            last = time.perf_counter()
        if cuda:
            torch.cuda.synchronize(dev)
            feeds = [a.elapsed_time(b) for a, b in spans]
        t_end = time.perf_counter()
        del out
    finally:
        it.close()
    n = args.n_batches
    interval = (t_end - t_first) / n
    rec = dict(
        route='device_aug' if args.device_aug else 'host',
        num_workers=args.num_workers, batch_size=args.batch_size,
        square_length=args.square_length, n_batches=n,
        loader_ms=sum(waits[1:]) / n * 1e3, interval_ms=interval * 1e3,
        samples_per_s=args.batch_size / interval,
        feed_ms=sum(feeds[1:]) / n, first_batch_s=waits[0],
        wall_s=t_end - t_start, device=str(dev),
        device_name=(torch.cuda.get_device_name(dev) if cuda else 'cpu'))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == '__main__':
    main()
