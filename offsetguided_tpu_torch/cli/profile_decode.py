#!/usr/bin/env python
"""Decode-path profile: the decode alone, and its stages, at the
benchmark's configuration (640^2, batch 8, top-k 32).

Port of the JAX package's `cli/profile_decode.py`, on the forward's own
outputs instead of its synthetic maps: one batch of seeded uint8 images
goes through the benchmark's model (Hourglass-104 bf16,
`random_posenet(seed=0)` calibrated at the size) once, and the decode of
those maps is timed (CUDA events on the card, host clock on the CPU).
`--stages` adds the per-stage times through `utils/profiling.StageTimer`
(the card synchronized at each stage's edges): the x4 upsample + NMS +
top-k (the fused peaks kernel on the card), limb collection from those
peaks, grouping (the grouping kernel), and the inverse transform of each
image's poses on the host (the device-to-host copy included).

    python -m offsetguided_tpu_torch.cli.profile_decode [--stages]

The last line is one JSON object with the same numbers.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

ITERS = 10          # timed calls of the decode and of each stage


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--size', type=int, default=640)
    ap.add_argument('--topk', type=int, default=32)
    ap.add_argument('--stages', action='store_true')
    ap.add_argument('--device', default=None,
                    help='torch device (default: the card)')
    ap.add_argument('--debug-tiny-model', action='store_true')
    args = ap.parse_args(argv)

    from ..config.defaults import DecoderConfig
    from ..data import transforms as T
    from ..decoder import PostProcessor
    from ..device import resolve_device
    from ..ops import decoder as dec
    from ..ops.cuda import grouping, peaks
    from ..utils.profiling import StageTimer, device_time
    from .profile_forward import build_forward
    from .serve import model_config

    dev = resolve_device(args.device)
    fwd, images = build_forward(args.batch, args.size, dev,
                                model_config(args))
    preds = fwd(images)
    del fwd
    cfg = DecoderConfig(topk=args.topk, thre_hmp=0.04, dist_max=40.0)
    pp = PostProcessor(cfg=cfg)
    with torch.inference_mode():
        total = device_time(pp.decode_body, preds, iters=ITERS)
    n = args.batch
    print(f'decode total: {total * 1e3:.2f} ms/batch-{n}')
    out = {'batch': n, 'size': args.size, 'topk': args.topk,
           'decode_ms': round(total * 1e3, 3)}
    if args.stages:
        maps = pp.select_stage(preds)
        hmp, omp = maps['hmp'], maps['omp']
        jomp, scmp = maps['jomp'], maps['scmp']
        b, h, w, c = hmp.shape
        s = cfg.stride
        jf, jt = pp._jf, pp._jt
        skeleton = tuple(zip(jf.tolist(), jt.tolist()))
        bt = hmp.permute(0, 3, 1, 2).reshape(b * c, h, w)
        meta = T.make_meta(args.size, args.size, c)
        timer = StageTimer(dev)
        with torch.inference_mode():
            for _ in range(ITERS):
                with timer.stage('upsample/peaks'):
                    vals, ys, xs = peaks.peaks_topk(bt, cfg.topk,
                                                    method=cfg.resize_mode)
                with timer.stage('limb collection'):
                    limbs = dec._collect_from_peaks(
                        vals.reshape(b, c, -1), ys.reshape(b, c, -1),
                        xs.reshape(b, c, -1), h * s, w * s, omp, jf, jt,
                        cfg, jomp, scmp, s)
                    packed = dec.pack_limbs(limbs)
                with timer.stage('grouping'):
                    poses, _, counts = grouping.group_skeletons(
                        packed, skeleton, cfg, c, capacity=cfg.capacity)
                with timer.stage('inverse'):
                    poses, counts = poses.cpu().numpy(), counts.cpu().numpy()
                    for i in range(b):
                        T.annotations_inverse(poses[i][:int(counts[i])], meta)
        stages = {k: v['mean_ms'] for k, v in timer.summary().items()}
        for k, ms in stages.items():
            print(f'  {k}: {ms:.3f} ms')
        out['stages_ms'] = stages
        out['poses_per_image'] = np.asarray(counts).tolist()
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    main()
