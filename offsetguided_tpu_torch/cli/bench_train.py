#!/usr/bin/env python
"""Training-step throughput benchmark (device-resident synthetic data).

Port of the JAX package's `cli/bench_train.py` with its flags, plus
`--device` (the card unless told otherwise). It times the train step
alone (`parallel/train_step.py`: forward in train mode, losses, backward,
the explosion guard, Adam) at the production configuration, on seeded
data already on the device, so memory and speed settings (`--remat`,
`--device-aug` with `--warp-impl`, batch size) can be compared in one
command. Each step first makes its targets on the device
(`encode_targets`), and with `--device-aug` first warps a raw canvas
(`augment_batch_dict`, simple rescale matrices). The loader is measured
by `cli/bench_data.py`; real training throughput is the smaller of the
two.

The weights are the JAX trainer's fresh initialization
(`init_reference_`, seed 0). Timing: the host clock over `--n2` and over
`--n1` steps, each run ending in a read of its last loss (a sync), the
two runs in turns `REPEATS` times; the step time is the difference of
their fastest runs over `n2 - n1` (the JAX tool times each once: a stall
of the host in the shorter run then gives a step time below zero).

Prints one JSON line: {"metric", "value", "unit", "config"}.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

REPEATS = 3         # runs of n1 and of n2 steps; the fastest of each counts


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--batch-size', type=int, default=16)
    p.add_argument('--square-length', type=int, default=512)
    p.add_argument('--remat', action='store_true')
    p.add_argument('--device-aug', action='store_true',
                   help='include the device augmentation (ops/augment.py) '
                        'in the measured step')
    p.add_argument('--raw-canvas', type=int, default=640)
    p.add_argument('--warp-impl', default='tiled',
                   choices=['patch', 'tiled'],
                   help='device-aug warp formulation (see cli/train.py)')
    p.add_argument('--n1', type=int, default=3)
    p.add_argument('--n2', type=int, default=9)
    p.add_argument('--debug-tiny-model', action='store_true')
    p.add_argument('--device', default=None,
                   help='torch device (default: the card)')
    args = p.parse_args(argv)

    from ..config import COCO_PERSON_SIGMAS, COCO_PERSON_SKELETON
    from ..config.defaults import (EncoderConfig, LossConfig, ModelConfig,
                                   TrainConfig)
    from ..device import resolve_device
    from ..models import PoseNet
    from ..models.network import init_reference_
    from ..ops.encoder import downscale_mask, encode_targets
    from ..parallel.train_step import TrainStep, make_optimizer

    dev = resolve_device(args.device)
    S, B, J = args.square_length, args.batch_size, 17
    if args.debug_tiny_model:
        cfg = ModelConfig(n_stacks=1, hg_order=2, dims=(16, 16, 24),
                          modules=(1, 1, 1), cnv_dim=16,
                          compute_dtype='float32', remat=args.remat)
    else:
        cfg = ModelConfig(remat=args.remat)
    model = init_reference_(PoseNet(cfg), torch.Generator().manual_seed(0))
    model = model.to(dev)
    step = TrainStep(model, make_optimizer(TrainConfig(), model.parameters()),
                     LossConfig())

    rng = np.random.RandomState(0)
    enc = EncoderConfig(max_persons=16)
    anns = np.zeros((B, 16, J, 4), np.float32)
    anns[:, :4, :, 0] = rng.rand(B, 4, J) * S
    anns[:, :4, :, 1] = rng.rand(B, 4, J) * S
    anns[:, :4, :, 2] = 2.0
    anns[:, :4, :, 3] = 16.0
    sig = np.asarray(COCO_PERSON_SIGMAS)
    out_hw = S // enc.stride

    if args.device_aug:
        from ..ops.augment import augment_batch_dict
        C0 = args.raw_canvas
        eye = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
        eye[:, 0, 0] = S / C0        # simple rescale matrices
        eye[:, 1, 1] = S / C0
        host = {
            'image': rng.randint(0, 255, (B, C0, C0, 3)).astype(np.uint8),
            'mask_miss': np.full((B, C0, C0), 255, np.uint8),
            'anns': anns * C0 / S,
            'aug_mat': eye,
            'aug_mat_inv': np.linalg.inv(eye)[:, :2].astype(np.float32),
            'aug_scale_xy': np.full((B, 2), S / C0, np.float32),
            'aug_flags': np.zeros((B, 2), np.float32),
            'aug_tint': np.zeros((B, 4), np.float32),
            'valid_hw': np.full((B, 2), C0, np.int32),
        }
        raw = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}

        @torch.no_grad()
        def prepare():
            imgs, mask01, anns2 = augment_batch_dict(
                raw, S, [1, 3], [2, 4], warp_impl=args.warp_impl)
            t = encode_targets(anns2, sig, COCO_PERSON_SKELETON, out_hw,
                               out_hw, enc)
            return imgs, t, downscale_mask(mask01, enc)
    else:
        images = torch.from_numpy(
            rng.randint(0, 255, (B, S, S, 3)).astype(np.uint8)).to(dev)
        anns_dev = torch.from_numpy(anns).to(dev)

        @torch.no_grad()
        def prepare():
            t = encode_targets(anns_dev, sig, COCO_PERSON_SKELETON, out_hw,
                               out_hw, enc)
            return images, t, torch.ones((B, out_hw, out_hw, 1),
                                         dtype=torch.bool, device=dev)

    def run_n(n):
        t0 = time.perf_counter()
        m = None
        for _ in range(n):
            m = step(*prepare())
        float(m['total'])                      # waits for the last step
        return time.perf_counter() - t0

    run_n(2)                                   # warm-up
    runs = [(run_n(args.n1), run_n(args.n2)) for _ in range(REPEATS)]
    t1, t2 = (min(r) for r in zip(*runs))
    dt = (t2 - t1) / (args.n2 - args.n1)
    out = {
        'metric': 'train_step_imgs_per_sec',
        'value': round(B / max(dt, 1e-9), 2),
        'unit': 'img/s',
        'config': {'batch': B, 'square': S, 'remat': args.remat,
                   'device_aug': args.device_aug,
                   'warp_impl': args.warp_impl if args.device_aug else None,
                   'tiny': args.debug_tiny_model, 'repeats': REPEATS,
                   'step_ms': round(dt * 1e3, 2),
                   'device': (torch.cuda.get_device_name(dev)
                              if dev.type == 'cuda' else str(dev))},
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    main()
    sys.exit(0)
