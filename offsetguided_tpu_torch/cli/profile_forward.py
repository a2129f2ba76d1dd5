#!/usr/bin/env python
"""Forward-pass profile: wall time and the top device operations.

Port of the JAX package's `cli/profile_forward.py`: the flagship forward
(Hourglass-104 + heads, bf16, BatchNorm folded) at the benchmark's
configuration (640^2, batch 8, `random_posenet(seed=0)` calibrated at the
size). Prints the time of one batch (CUDA events on the card, host clock
on the CPU), the images per second, the convolution FLOPs counted by
`torch.utils.flop_counter` (convolutions and matmuls) and their rate,
then the 10 top operations of a
torch.profiler run over `--trace-iters` batches by total device time
(CUDA kernels on the card; CPU operator time on the CPU): name, calls, ms,
share. `--log-dir` also writes the run as a Chrome trace.

    python -m offsetguided_tpu_torch.cli.profile_forward [--log-dir D]

The last line is one JSON object with the same numbers.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

TOP = 10            # operations listed


def build_forward(batch: int, size: int, device, model_cfg=None):
    """-> (forward, images): the inference forward of the benchmark's
    model (normalizing on the device) and a seeded uint8 batch."""
    from ..config.defaults import ModelConfig
    from ..models import random_posenet
    from ..ops.image import normalize_images

    model = random_posenet(model_cfg or ModelConfig(), 0, device=device,
                           calib_size=size).prepare_inference()
    images = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (batch, size, size, 3), dtype=np.uint8)).to(device)

    @torch.inference_mode()
    def forward(x):
        return model(normalize_images(x))

    forward.model = model
    return forward, images


def top_ops(prof, device, top: int):
    """[(name, calls, ms, share)] of the profiler's operations by total
    device time (CUDA) or CPU self time (CPU), largest first."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if device.type == 'cuda':
            if e.device_type != DeviceType.CUDA or e.device_time_total <= 0:
                continue
            us = e.device_time_total
        else:
            if e.self_cpu_time_total <= 0:
                continue
            us = e.self_cpu_time_total
        rows.append((e.key, e.count, us / 1e3))
    total = sum(r[2] for r in rows) or 1.0
    rows.sort(key=lambda r: -r[2])
    return [(n, c, ms, ms / total) for n, c, ms in rows[:top]], total


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--size', type=int, default=640)
    ap.add_argument('--trace-iters', type=int, default=3)
    ap.add_argument('--log-dir', default=None,
                    help='write the profiled run as a Chrome trace here')
    ap.add_argument('--device', default=None,
                    help='torch device (default: the card)')
    ap.add_argument('--debug-tiny-model', action='store_true')
    args = ap.parse_args(argv)

    from torch.utils.flop_counter import FlopCounterMode

    from ..device import resolve_device
    from ..utils.profiling import device_time, trace
    from .serve import model_config

    dev = resolve_device(args.device)
    fwd, images = build_forward(args.batch, args.size, dev,
                                model_config(args))
    with FlopCounterMode(display=False) as counter:
        fwd(images)
    flops = counter.get_total_flops()
    dt = device_time(fwd, images, iters=5)
    print(f'forward {args.size}^2 batch {args.batch}: {dt * 1e3:.2f} '
          f'ms/batch ({args.batch / dt:.1f} img/s, {flops / dt / 1e12:.1f} '
          f'TFLOP/s of {flops / 1e12:.3f} TFLOP)')

    with trace(args.log_dir, dev) as prof:
        for _ in range(args.trace_iters):
            fwd(images)
    rows, total = top_ops(prof, dev, TOP)
    print(f'--- top {len(rows)} of {total:.1f} ms '
          f'{"device" if dev.type == "cuda" else "CPU"} time over '
          f'{args.trace_iters} batches ---')
    for name, calls, ms, share in rows:
        print(f'{ms:9.2f} ms  x{calls:<5d} {share:6.1%}  {name[:100]}')
    out = {'batch': args.batch, 'size': args.size,
           'ms_per_batch': round(dt * 1e3, 3),
           'img_per_s': round(args.batch / dt, 2),
           'tflop_per_batch': round(flops / 1e12, 4),
           'tflop_per_s': round(flops / dt / 1e12, 2),
           'profiled_ms': round(total, 3), 'trace_iters': args.trace_iters,
           'top_ops': [{'name': n, 'calls': c, 'ms': round(ms, 3),
                        'share': round(s, 4)} for n, c, ms, s in rows]}
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    main()
