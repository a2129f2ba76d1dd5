#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the four CUDA kernels from `offsetguided_tpu_torch/csrc/` (one nvcc
per source, in parallel), holds each against its plain PyTorch version at
its path's shapes (grouping also on a capacity-128 crowd at top-k 96, on
the JAX package's adversarial and overflow inputs and on crowds with
max_poses above the capacity, whose rows past the kept ones must be
zero), and drives the
port's entry points at full width (Hourglass-104, random seeded weights,
batch 8, bf16):
- serving at 640x640 with flip-test off and on, and concurrent requests
  through the micro-batcher (peaks + grouping kernels);
- `cli.evaluate.main` over 16 seeded .npy images in the hard set's shapes,
  fixed height 640 with flip-test (non-square maps: block top-k +
  grouping kernels) and stride-resolution decode (NMS + top-k, reading the
  head's channel slice in place, + grouping);
- `cli.simulate.main`, the GT oracle, on the 100-image hard annotations,
  upsampled (fused peaks) and stride-resolution decode, against the JAX
  package's recorded APs; and one fixed-height GT batch decoded through
  the kernels and through the plain versions on the card;
- `[crowd oracle]`: the crowd-scale stress set (30 scenes of 50-70
  people, built here by the port's generator and codec; its annotations
  the JAX generator's bytes) through `cli.simulate --topk 80
  --max-persons 70` at six capacity / max_poses rows of the JAX
  package's recorded sweep (16/40, 32/40, 64/20, 64/40, 64/80, 256/80),
  each AP within 0.002 of the JAX package's CPU value, the kernels'
  records equal to the plain versions' at 16/40 and 256/80, and the
  grouping kernel timed on the crowd limbs there;
- `cli.train.main` at full width (512^2, batch 16, Adam, 12 steps) on the
  device-augmentation route, its checkpoint served, and on the host
  augmentation route with 4 loader processes and the validation pass;
  the loader's ms a batch by worker count (`cli.bench_data`);
- `cli.selfcheck.main` on both augmentation routes (AP >= 0.7 with AP50 =
  AP75 = 1.0; its evaluation launches the fused peaks and grouping
  kernels), the trained model's records equal to the plain versions';
- one fp32 train step of a tiny model, card against CPU, on a seeded
  batch and on a host-route batch;
- data parallel (`cli.train --distributed`): `[ddp]` at world size 1 over
  NCCL in turns with one process (img/s, peak memory), then two gloo
  ranks sharing the card (global losses, ranks bit-equal, rank 0 alone
  writing the checkpoint, peak memory a rank); `[ddp one-step]` (one
  card process against two gloo ranks on the card, the one-step
  tolerances); `[dryrun]` (`parallel/dryrun.py::dryrun_multichip(2)` on
  the card);
- the CrowdPose configuration (14 keypoints, 17 limbs; the grouping
  kernel's general build): `[crowdpose]` serving at full width, flip off
  and on, with every kernel held against its plain version at M = 8 * 14
  and a J = 14 crowd at capacity 128; `[crowdpose oracle]` (99 scenes,
  upsampled and stride-resolution decode, card APs equal to the CPU's
  plain path); `[crowdpose evaluate]` (`cli.evaluate --dataset crowdpose`,
  fixed height + flip and lowres); `[crowdpose serve http]`; `[train
  crowdpose]` (4 full-width steps);
- the 4-stage backbone: `[train 4stage]` (`cli.train --basenet
  hourglass4stage` at the JAX CLI's defaults, 8 steps, host route, 4
  loader processes, validation) and `[4stage reference]` (fp32 eval
  forward and an fp64 step card vs CPU, and the 3x3 tower heads);
- the last five tools: `[demo]` (`cli.demo` on four hard-set JPEGs with
  flip test and every picture; poses equal to `cli.serve.build_infer`'s),
  `[export]` (`cli.export --with-decode` at 512^2: parameters, GMACs, the
  `torch.export` program loaded and run in a fresh process, bit-equal to
  eager, the peaks and grouping custom ops in its graph and launched),
  `[bench_train]` (resident data, device augmentation on the patch and
  the tiled warp), `[bench_warp]` (`--full`, tiled within the JAX
  package's tolerance of patch) and `[bench_stem]` (every formulation
  equal to `plain`); and `[dispatch]`, the serving path through the
  kernels' custom ops against their CUDA implementations called
  directly, in turns;
- `[transforms]` on the card's host, which has no cv2: the JAX
  package's optional `blur`, `jpeg_compression` and `ImageList` give the
  pixels whose cv2 digests a CPU test pinned; `blur`'s host ms;
- the port's JPEG / PNG codec built on the card's host (`[codec]`: pinned
  body and pixel digests, the committed progressive bodies' pixels,
  decode ms of a baseline and a progressive 480x640 body), and the serving front end and its
  tools: `cli.serve`'s HTTP server on port 0 (48 concurrent JPEG POSTs,
  upsampled and `--lowres-decode`), `cli.bench`, `cli.bench_serve` (the
  server as a subprocess, concurrency 16 for 15 s), `cli.bench_e2e` (100
  hard-set JPEGs from disk, flip off / on, and fixed height),
  `cli.profile_forward` and `cli.profile_decode --stages`.
The three selection kernels are also held against their plain versions
at k = 1024. Each path zeroes the kernels' launch counts just before it
runs and reads them just after; each must have launched the kernels of its
route. Prints
the card, the build, each phase, one `{"kernels": [...]}` line, and as its
last line `{"ok": true, "device": {...}}`. Any failed phase exits non-zero
before the last line. Needs a CUDA device; never touches JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

PEAK_FP32_FLOPS = 67e12        # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12           # H100 SXM HBM3
N_IMG, LONG_EDGE, TOPK = 8, 640, 32
STRIDE, J, L = 4, 17, 19
KERNELS = ('peaks', 'grouping', 'topk', 'nms_topk')
# the JAX package's oracle APs on the 100-image hard set (CPU f32,
# BENCHMARKS.md): upsampled decode, stride-resolution decode
ORACLE_AP = {'upsampled': 0.6592, 'lowres': 0.6544}
ORACLE_ARGS = ['--topk', '32', '--thre-hmp', '0.04', '--dist-max', '40',
               '--max-persons', '16']


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f'FAILED: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_time(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over `iters` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def launch_split(fn, iters: int = 20, parts=('tile', 'merge')) -> dict:
    """Device milliseconds per launch of each `<part>_kernel` that `fn`
    launches (by default a two-launch kernel's tile and merge kernels), by
    torch.profiler over `iters` calls: {'tile_ms', 'merge_ms'}, None where
    the profiler recorded no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {f'{part}_ms': None for part in parts}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.device_time_total > 0:
            for part in parts:
                if f'{part}_kernel' in e.key:
                    out[f'{part}_ms'] = e.device_time_total / 1e3 / e.count
    return out


def split_text(split: dict) -> str:
    return ', '.join(f'{k[:-3]} launch ' + ('not measured' if v is None
                                            else f'{v:.4f} ms')
                     for k, v in split.items())


# --------------------------------------------------------------------------- #
# inputs made from seeds
# --------------------------------------------------------------------------- #

TEMPLATE = np.array([
    [0.50, 0.07], [0.46, 0.05], [0.54, 0.05], [0.42, 0.07], [0.58, 0.07],
    [0.36, 0.22], [0.64, 0.22], [0.32, 0.40], [0.68, 0.40], [0.30, 0.57],
    [0.70, 0.57], [0.41, 0.54], [0.59, 0.54], [0.40, 0.75], [0.60, 0.75],
    [0.39, 0.95], [0.61, 0.95]], dtype=np.float32)


def person_maps(n: int, h: int, w: int, skeleton, seed: int = 0):
    """Stride-4 prediction maps of random stick-figure scenes: Gaussian
    heatmaps (sigma 7 px), guiding offsets to the limb's end joint in a
    7x7-cell window around each start joint, scales 8, zero jitter."""
    rng = np.random.RandomState(seed)
    H, W = h * STRIDE, w * STRIDE
    cy = np.arange(h)[:, None] * STRIDE + 1.5
    cx = np.arange(w)[None, :] * STRIDE + 1.5
    hmp = np.zeros((n, h, w, J), np.float32)
    omp = np.zeros((n, h, w, 2 * len(skeleton)), np.float32)
    for i in range(n):
        for _ in range(1 + i % 5):
            box = rng.uniform(0.2, 0.6) * min(H, W)
            x0, y0 = rng.uniform(0, W - box), rng.uniform(0, H - box)
            kp = np.stack([x0 + TEMPLATE[:, 0] * box,
                           y0 + TEMPLATE[:, 1] * box], -1) + rng.rand(J, 2)
            for j in range(J):
                g = np.exp(-((cx - kp[j, 0]) ** 2 + (cy - kp[j, 1]) ** 2)
                           / (2 * 7.0 ** 2))
                hmp[i, :, :, j] = np.maximum(hmp[i, :, :, j], g)
            for l, (jf, jt) in enumerate(skeleton):
                ci, cj = int(kp[jf, 1] // STRIDE), int(kp[jf, 0] // STRIDE)
                sl = (i, slice(max(ci - 3, 0), ci + 4),
                      slice(max(cj - 3, 0), cj + 4))
                omp[sl + (2 * l,)] = kp[jt, 0] - kp[jf, 0]
                omp[sl + (2 * l + 1,)] = kp[jt, 1] - kp[jf, 1]
    return {'hmp': hmp, 'omp': omp,
            'jomp': np.zeros((n, h, w, 2), np.float32),
            'scmp': np.full((n, h, w, J), 8.0, np.float32)}


def peak_inputs(b: int, h: int, w: int, skeleton):
    rng = np.random.RandomState(1)
    pm = person_maps(b // J, h, w, skeleton, seed=2)
    return {
        'pow4': rng.rand(b, h, w).astype(np.float32) ** 4,
        'eighths': (np.round(rng.rand(b, h, w) * 8) / 8).astype(np.float32),
        'persons': pm['hmp'].transpose(0, 3, 1, 2).reshape(b, h, w),
    }


def crowd_limbs(n_img: int, K: int, seed: int, L: int = L, skeleton=None):
    """(n_img, L, K, 13) float32 packed limbs of a dense crowd on the first
    L limbs of `skeleton` (default COCO's): 9 in 10 candidates valid,
    keypoint indices per joint drawn from a pool of 2K, so that rows
    extend, collide, merge and run out of free rows; scores quantized to
    hundredths, so that ties are common."""
    from offsetguided_tpu_torch.config import COCO_PERSON_SKELETON
    rng = np.random.RandomState(seed)
    out = np.zeros((n_img, L, K, 13), np.float32)
    for l, (jf, jt) in enumerate((skeleton or COCO_PERSON_SKELETON)[:L]):
        shape = (n_img, K)
        out[:, l, :, 0:2] = rng.uniform(1, 600, shape + (2,))
        out[:, l, :, 2] = rng.uniform(0.1, 1, shape)
        out[:, l, :, 3:5] = rng.uniform(1, 600, shape + (2,))
        out[:, l, :, 5] = rng.uniform(0.1, 1, shape)
        out[:, l, :, 6] = jf * 100_000 + rng.randint(2 * K, size=shape)
        out[:, l, :, 7] = jt * 100_000 + rng.randint(2 * K, size=shape)
        out[:, l, :, 8] = np.where(rng.rand(*shape) < 0.9, 1.0, 50.0)
        out[:, l, :, 9] = 10.0
        out[:, l, :, 10] = np.round(rng.rand(*shape), 2)
        out[:, l, :, 11:13] = 6.0
    return out


# the grouping inputs of the JAX package's adversarial and overflow tests
# (tests/test_grouping_adversarial.py, tests/test_grouping_overflow.py),
# rebuilt here without JAX; tests/test_torch_port_grouping_adversarial.py
# holds these functions equal to those on the CPU

SK4, J4 = ((1, 3), (1, 2)), 5
FUZZ_SK, FUZZ_J = ((1, 3), (2, 4), (1, 2), (3, 4), (4, 5)), 7
CROWD_SK = tuple((i % 17, (i + 1) % 17) for i in range(19))
ADV_CFG = dict(person_thre=0.01, dist_max=20.0, use_scale=False, max_poses=8)


def conn(x1, y1, v1, x2, y2, v2, i1, i2, delta, length, score, s1=6.0,
         s2=6.0):
    return [x1, y1, v1, x2, y2, v2, i1, i2, delta, length, score, s1, s2]


def empty_limbs(L, K):
    limbs = np.zeros((L, K, 13), dtype=np.float64)
    limbs[:, :, 0:2] = -99999.0
    limbs[:, :, 3:5] = -99999.0
    return limbs


def chain_limbs():
    """Three rows spawned from one shared start keypoint, co-extended by one
    conn at the final limb type: three merge pairs at once."""
    limbs = empty_limbs(2, 4)
    limbs[0, 0] = conn(10, 10, .9, 14, 20, .8, 101, 103, 1.0, 10.0, .70)
    limbs[0, 1] = conn(10, 10, .9, 10, 21, .8, 101, 999, 1.0, 10.0, .65)
    limbs[0, 2] = conn(10, 10, .9, 6, 20, .8, 101, 303, 1.0, 10.0, .60)
    limbs[1, 0] = conn(10, 10, .9, 10, 15, .85, 101, 102, 1.0, 5.0, .80)
    return limbs


def equal_tie_limbs():
    """Two conns with equal scores and one end index: the first is kept."""
    limbs = empty_limbs(2, 4)
    limbs[0, 0] = conn(10, 10, .9, 14, 20, .8, 101, 103, 1.0, 10.0, .5)
    limbs[0, 1] = conn(30, 30, .9, 14, 20, .8, 201, 103, 1.0, 10.0, .5)
    return limbs


def extension_tie_limbs():
    """Two conns of one type extend one row at the same joint."""
    limbs = empty_limbs(2, 4)
    limbs[0, 0] = conn(10, 10, .9, 14, 20, .8, 101, 103, 1.0, 10.0, .7)
    limbs[1, 0] = conn(10, 10, .9, 10, 15, .9, 101, 102, 1.0, 5.0, .8)
    limbs[1, 1] = conn(10, 10, .9, 12, 15, .6, 101, 202, 1.0, 5.0, .3)
    return limbs


def fuzz_trials(rng, n=10):
    """The tie-prone fuzz of test_adversarial_fuzz_three_way_parity, drawn
    in its order: shared starts, quantized scores, deltas straddling
    dist_max, off-image pushes. One (5, 6, 13) limb block per trial."""
    out = []
    for _ in range(n):
        K = 6
        limbs = empty_limbs(len(FUZZ_SK), K)
        ind_pool = rng.randint(100, 112, size=40)
        for l in range(len(FUZZ_SK)):
            for k in range(K):
                if rng.rand() < 0.25:
                    continue
                i1 = int(ind_pool[rng.randint(len(ind_pool))])
                i2 = int(ind_pool[rng.randint(len(ind_pool))])
                score = round(float(rng.rand()), 1)
                delta = float(rng.choice([1.0, 19.9, 20.0, 25.0]))
                x1, y1 = float(rng.randint(1, 50)), float(rng.randint(1, 50))
                x2, y2 = float(rng.randint(1, 50)), float(rng.randint(1, 50))
                if rng.rand() < 0.15:
                    x1 = -99999.0
                limbs[l, k] = conn(x1, y1, .9, x2, y2, .8, i1, i2, delta,
                                   10.0, score)
        out.append(limbs)
    return out


def make_crowd(n_limbs_valid, k=96, L=19):
    """(1, L, K, 13): limb type 0 has `n_limbs_valid` disjoint valid
    candidates in descending score, the other types none."""
    packed = np.zeros((1, L, k, 13), np.float32)
    packed[..., 0:2] = -100000.0
    packed[..., 3:5] = -100000.0
    for i in range(n_limbs_valid):
        x = 10.0 + 6.0 * i
        packed[0, 0, i, 0:3] = [x, 10.0, 0.9]
        packed[0, 0, i, 3:6] = [x, 20.0, 0.9]
        packed[0, 0, i, 6] = 1000 + 2 * i
        packed[0, 0, i, 7] = 1001 + 2 * i
        packed[0, 0, i, 8] = 1.0
        packed[0, 0, i, 9] = 10.0
        packed[0, 0, i, 10] = 1.0 - 0.005 * i
        packed[0, 0, i, 11:13] = 5.0
    return packed


def crowd_cfg(capacity):
    return dict(topk=96, dist_max=40.0, use_scale=False, person_thre=0.05,
                max_poses=96, capacity=capacity)


# a dense crowd at capacity 16 with max_poses 40: every image fills its
# rows, and the ranks from 16 on must come out zero
CROWD_16_40 = dict(topk=48, dist_max=40.0, use_scale=False, person_thre=0.05,
                   max_poses=40, capacity=16)


def adversarial_cases():
    """name -> (packed (N, L, K, 13) float32, skeleton, J, DecoderConfig
    keywords, the capacity among them) for every input of the JAX
    adversarial and overflow tests."""
    cases = {
        'chain': (chain_limbs()[None], SK4, J4, ADV_CFG),
        'chain_no_settle': (chain_limbs()[None], SK4, J4,
                            dict(ADV_CFG, settle_passes=0)),
        'equal_tie': (equal_tie_limbs()[None], SK4, J4, ADV_CFG),
        'extension_tie': (extension_tie_limbs()[None], SK4, J4, ADV_CFG),
        'fuzz': (np.stack(fuzz_trials(np.random.RandomState(0))), FUZZ_SK,
                 FUZZ_J, dict(ADV_CFG, max_poses=12)),
    }
    for n_valid, cap in ((40, 64), (78, 64), (78, 128)):
        cases[f'crowd_{n_valid}_{cap}'] = (make_crowd(n_valid), CROWD_SK, 17,
                                           crowd_cfg(cap))
    return {name: (x.astype(np.float32), sk, j, dict(cfg, capacity=cfg.get(
        'capacity', 64))) for name, (x, sk, j, cfg) in cases.items()}


def pose_sets_match(p, rp, counts, atol: float) -> bool:
    """Per image, the first counts[i] pose rows of `p` and `rp` match one
    to one within `atol` (greedily, in order, as the JAX package's
    adversarial tests match them: poses whose scores tie to the last bit of
    a float sum may swap places), and the rows after them are equal."""
    p, rp = p.cpu().numpy(), rp.cpu().numpy()
    for i, c in enumerate(counts.tolist()):
        c = min(c, p.shape[1])
        if not np.array_equal(p[i, c:], rp[i, c:]):
            return False
        unused = list(range(c))
        for row in p[i, :c]:
            hit = next((j for j in unused
                        if np.allclose(row, rp[i, j], rtol=0, atol=atol)), None)
            if hit is None:
                return False
            unused.remove(hit)
    return True


def with_sentinels(packed):
    """Copy of packed limbs with +inf off-image rows, NaN rows and one NaN
    scale, and keypoint indices lifted by 2.5 M."""
    x = packed.clone()
    x[..., 6:8] += 2_500_000.0
    off = x[..., 2] < 0.04
    for c in (0, 1, 8):
        x[..., c].masked_fill_(off, float('inf'))
    x[:, ::3, -1, :] = float('nan')
    x[:, 1, 0, 12] = float('nan')
    return x


# CrowdPose-style scenes: the template and placements of the JAX package's
# tests/test_crowdpose_e2e.py, rebuilt without JAX for the card
# (`[crowdpose oracle]`, `[crowdpose evaluate]`, `[train crowdpose]`);
# tests/test_torch_port_crowdpose.py holds them equal to that test's, and
# `crowdpose_oracle` on the CPU equal to the JAX package's oracle loop.
J14, L17 = 14, 17
TEMPLATE14 = np.array([
    [0.36, 0.22], [0.64, 0.22], [0.32, 0.40], [0.68, 0.40],
    [0.30, 0.57], [0.70, 0.57], [0.41, 0.54], [0.59, 0.54],
    [0.40, 0.75], [0.60, 0.75], [0.39, 0.95], [0.61, 0.95],
    [0.50, 0.02], [0.50, 0.16]], dtype=np.float32)
CROWDPOSE_SCENES = (                   # (crowdIndex, (x0, y0, box) each)
    (0.00, ((60, 40, 150),)),
    (0.05, ((20, 30, 140), (170, 60, 120))),
    (0.40, ((10, 30, 120), (150, 60, 110))),
    (0.50, ((30, 10, 130), (180, 40, 100))),
    (0.90, ((20, 20, 140), (110, 40, 130), (210, 30, 90))),
    (0.95, ((40, 30, 150), (150, 50, 120))),
)
# the JAX test's decode settings for these scenes, at 160^2
CROWDPOSE_DECODE = dict(topk=12, thre_hmp=0.1, dist_max=20.0, use_scale=False,
                        person_thre=0.1, max_poses=8)
CROWDPOSE_SIZE = 160


def crowdpose_persons(placements, seed: int = 11) -> np.ndarray:
    """(P, 14, 3) keypoints of upright figures at absolute positions."""
    jig = np.random.RandomState(seed)
    kps = np.zeros((len(placements), J14, 3), np.float32)
    for i, (x0, y0, box) in enumerate(placements):
        kps[i, :, 0] = x0 + TEMPLATE14[:, 0] * box + jig.rand(J14) * 0.73
        kps[i, :, 1] = y0 + TEMPLATE14[:, 1] * box + jig.rand(J14) * 0.73
        kps[i, :, 2] = 2
    return kps


def crowdpose_annotations(scenes, ext: str = 'jpg'):
    """COCO-style annotations of 320x256 `scenes` with each image's
    crowdIndex, as the JAX test's fixture writes them, and {image id:
    (P, 14, 3) keypoints}."""
    images, annotations, gt_kps = [], [], {}
    ann_id = 1
    for img_id, (ci, placements) in enumerate(scenes, start=1):
        kps = crowdpose_persons(placements, seed=img_id)
        gt_kps[img_id] = kps
        for k in kps:
            bx, by = k[:, 0].min() - 3, k[:, 1].min() - 3
            bw = k[:, 0].max() - k[:, 0].min() + 6
            bh = k[:, 1].max() - k[:, 1].min() + 6
            annotations.append({
                'id': ann_id, 'image_id': img_id, 'category_id': 1,
                'keypoints': k.reshape(-1).tolist(), 'num_keypoints': J14,
                'iscrowd': 0,
                'bbox': [float(bx), float(by), float(bw), float(bh)],
                'area': float(bw * bh * 0.6),
            })
            ann_id += 1
        images.append({'id': img_id, 'file_name': f'{img_id:06d}.{ext}',
                       'height': 256, 'width': 320, 'crowdIndex': ci})
    return ({'images': images, 'annotations': annotations,
             'categories': [{'id': 1, 'name': 'person'}]}, gt_kps)


def crowdpose_scenes(n: int, seed: int):
    """`n` scenes in the manner of CROWDPOSE_SCENES: image i % 3 is easy
    (crowdIndex below 0.1, 1-2 persons), medium (0.1-0.8, 2-3) or hard
    (0.8-1.0, 3-4), persons of 90-150 px placed at random in the
    320x256 image."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        band = i % 3
        ci = float(np.round(rng.uniform(*((0.0, 0.1), (0.1, 0.8),
                                          (0.8, 1.0))[band]), 3))
        placements = []
        for _ in range(1 + band + rng.randint(2)):
            box = float(rng.randint(90, 151))
            placements.append((float(rng.randint(0, int(320 - 0.7 * box))),
                               float(rng.randint(0, int(256 - box))), box))
        out.append((ci, tuple(placements)))
    return tuple(out)


def crowdpose_oracle(ann_file: str, dev, upsampled: bool = True,
                     batch: int = 16):
    """The CrowdPose GT oracle through the port: each person image's
    annotations rescaled and padded to 160^2, GT encoded on `dev`,
    decoded there (the kernels on a CUDA device, the plain versions on
    the CPU) in batches, inverse transformed, and scored by
    `evaluate_crowdpose_keypoints`. Returns (results, stats, launches):
    the kernels launched by the decode, read around it."""
    import torch
    from offsetguided_tpu_torch.config.defaults import (
        DecoderConfig, EncoderConfig, SkeletonConfig)
    from offsetguided_tpu_torch.data import transforms as T
    from offsetguided_tpu_torch.data.coco import CocoJson
    from offsetguided_tpu_torch.decoder import PostProcessor
    from offsetguided_tpu_torch.eval.cocoeval import \
        evaluate_crowdpose_keypoints
    from offsetguided_tpu_torch.eval.harness import poses_to_coco_results
    from offsetguided_tpu_torch.ops.encoder import encode_targets

    sk = SkeletonConfig.crowdpose()
    size = CROWDPOSE_SIZE
    pp = PostProcessor(skeleton=sk, cfg=DecoderConfig(
        upsampled_decode=upsampled, **CROWDPOSE_DECODE))
    coco = CocoJson(ann_file)
    ids = coco.image_ids(with_persons=True)
    padded, metas = [], []
    for img_id in ids:
        info = coco.image_info(img_id)
        anns = T.normalize_annotations(coco.anns_for_image(img_id),
                                       sk.sigmas, n_keypoints=J14)
        meta = T.make_meta(info['width'], info['height'])
        dummy = np.zeros((info['height'], info['width'], 3), np.uint8)
        img2, anns, meta = T.rescale_long_absolute(dummy, anns, meta, size)
        _, anns, meta = T.center_pad(img2, anns, meta, size)
        p = np.zeros((8, J14, 4), np.float32)
        p[:len(anns)] = anns[:8]
        padded.append(p)
        metas.append(meta)
    results, launches = [], {k: 0 for k in KERNELS}
    for b0 in range(0, len(ids), batch):
        anns = torch.from_numpy(np.stack(padded[b0:b0 + batch])).to(dev)
        with torch.inference_mode():
            t = encode_targets(anns, sk.sigmas, sk.skeleton, size // 4,
                               size // 4, EncoderConfig(max_persons=8))
            preds = {'hmp': [t.hmp], 'jomp': [t.jomp], 'omp': [t.omp],
                     'scmp': [None]}
            if dev.type == 'cuda':
                reset_launches()
            poses, _, counts = pp.decode_body(preds)
            poses, counts = poses.cpu().numpy(), counts.cpu().numpy()
            if dev.type == 'cuda':
                launches = {k: launches[k] + v
                            for k, v in read_launches().items()}
        for i, img_id in enumerate(ids[b0:b0 + batch]):
            inv = T.annotations_inverse(poses[i][:int(counts[i])],
                                        metas[b0 + i])
            results.extend(poses_to_coco_results(inv, img_id))
    stats = evaluate_crowdpose_keypoints(coco, results, np.asarray(sk.sigmas))
    return results, stats, launches


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #

# The [codec] phase's bodies: seeded images through the port's encoders,
# each sampling mode of the JPEG encoder, restart markers, grey, and PNG.
# CODEC_DIGESTS pins the SHA-256 of each body and of its decoded pixels
# (tests/test_torch_port_codec.py holds them, and the pixels equal to
# cv2.imdecode's, on the CPU); the card's host must reproduce both. A PNG
# body's bytes are zlib's, which may differ between zlib versions: only
# its pixels are pinned.
CODEC_CASES = (('jpeg 444 q95', '444', 95, 0, False, (97, 153)),
               ('jpeg 422 q95', '422', 95, 0, False, (97, 153)),
               ('jpeg 420 q95', '420', 95, 0, False, (480, 640)),
               ('jpeg 440 q95', '440', 95, 0, False, (97, 153)),
               ('jpeg 411 q95', '411', 95, 0, False, (97, 153)),
               ('jpeg 420 q50 restart 3', '420', 50, 3, False, (17, 3)),
               ('jpeg grey q75', '420', 75, 0, True, (33, 41)),
               ('png rgb', None, 0, 0, False, (61, 47)),
               ('png grey', None, 0, 0, True, (61, 47)))
# name -> (first 16 hex digits of the body's SHA-256, of the pixels')
CODEC_DIGESTS = {
    'jpeg 444 q95': ('e20411d82ea5565a', '274bd5cfa68df581'),
    'jpeg 422 q95': ('cb68b41d328fbf8c', '51454eee53771957'),
    'jpeg 420 q95': ('bc448f8a938e17d3', '497b647b8816af9c'),
    'jpeg 440 q95': ('45936e2f3c0c26d1', '51b9dd77fff83b55'),
    'jpeg 411 q95': ('cb463fc63731f19d', '7f65a38e91607a30'),
    'jpeg 420 q50 restart 3': ('73545f45a2d400ef', 'e37e6c7e51dfa737'),
    'jpeg grey q75': ('d7cad481efa6d66b', '99a4951ce957bffa'),
    'png rgb': (None, '8d57d6096548b0f1'),
    'png grey': (None, '12c7c2080c682715'),
}


# Progressive JPEG bodies written by cv2.imencode (IMWRITE_JPEG_PROGRESSIVE,
# libjpeg-turbo's scan script) from `codec_image` scenes, committed under
# tests/torch_port_data/ (the port's encoder writes baseline only): name ->
# (file, body digest, pixel digest); the pixel digests are cv2.imdecode's,
# pinned on the CPU by tests/test_torch_port_codec_progressive.py. The
# 480x640 4:2:0 q95 scene is 'jpeg 420 q95''s, and decodes to its pixels.
PROGRESSIVE_DIR = os.path.join('tests', 'torch_port_data')
PROGRESSIVE_DIGESTS = {
    'progressive 420 q95': ('prog_420_q95.jpg', '0d6459c97007503a',
                            '497b647b8816af9c'),
    'progressive 444 q90': ('prog_444_q90.jpg', '579f926c0039390a',
                            'e1c4adf84acd3f62'),
    'progressive grey q75': ('prog_grey_q75.jpg', '0a61e47fcd672ca4',
                             '6b7d8476d6911629'),
    'progressive 420 q50 restart 2': ('prog_420_q50_rst2.jpg',
                                      'ff98666828a54b2e', 'd175baedcf10c396'),
}


def progressive_cases(digests=None):
    """[(name, body)] of the committed bodies of `digests` (default
    PROGRESSIVE_DIGESTS)."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = []
    for name, (fn, _, _) in (digests or PROGRESSIVE_DIGESTS).items():
        with open(os.path.join(root, PROGRESSIVE_DIR, fn), 'rb') as f:
            out.append((name, f.read()))
    return out


# Bodies of the JPEG processes cv2.imdecode reads beyond Huffman coding of
# one or three components, committed under tests/torch_port_data/ (the
# card's host has no cv2 or Pillow): the arithmetic ones are lossless
# transcodes of `codec_image` scenes' Huffman bodies by
# tests/torch_port_jpeg_writer.py, the CMYK one Pillow's, the YCCK one the
# writer's, the smoothed one cv2's progressive body without its last three
# refinement scans (libjpeg smooths its blocks). name -> (file, body
# digest, pixel digest); the pixel digests are cv2.imdecode's, pinned on the
# CPU by tests/test_torch_port_codec_arith.py.
JPEG_FILE_DIGESTS = {
    'arithmetic 420 restart 2 DAC': ('arith_420_rst2_dac.jpg',
                                     'e2f7f377b7764c70', '634408402aadc47d'),
    'arithmetic progressive 444': ('arith_prog_444.jpg', 'f4518ab2a9e74230',
                                   '0ba604264421e47d'),
    'Pillow CMYK 420': ('cmyk_420.jpg', '9ae804ff310e718b',
                        'ef8e38bc4f50b60c'),
    'YCCK 422': ('ycck_422.jpg', 'df8a2e7eec8e8d3f', 'f31dbcc586dc14ac'),
    'progressive smoothed 420': ('prog_smooth_420.jpg', 'fb164e6c14af21aa',
                                 'c93684f24b64fd87'),
}
# the arithmetic twin of 'jpeg 420 q95' (480x640), transcoded on the host
# by tests/torch_port_jpeg_writer.py: its body digest; its pixels are
# 'jpeg 420 q95''s
ARITH_480_DIGEST = '89d2be2f16cdd067'


@functools.lru_cache(maxsize=2)
def arithmetic_twin(body: bytes) -> bytes:
    """The arithmetic-coded twin of a Huffman body (the test writer's
    lossless transcode)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'tests',
                        'torch_port_jpeg_writer.py')
    spec = importlib.util.spec_from_file_location('torch_port_jpeg_writer',
                                                  path)
    writer = sys.modules.setdefault(spec.name,
                                    importlib.util.module_from_spec(spec))
    if not hasattr(writer, 'transcode'):
        spec.loader.exec_module(writer)
    return writer.transcode(body)


def codec_digests(body: bytes, pixels: np.ndarray):
    """(body digest, pixel digest) as CODEC_DIGESTS holds them."""
    import hashlib
    return (hashlib.sha256(body).hexdigest()[:16],
            hashlib.sha256(np.ascontiguousarray(pixels).tobytes()
                           ).hexdigest()[:16])


def codec_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A seeded (h, w, 3) uint8 RGB scene: smooth gradients, noise and a
    painted stick figure."""
    from offsetguided_tpu_torch.data.draw import circle, line3
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // max(w, 1), yy * 255 // max(h, 1),
                    (xx + yy) % 256], -1).astype(np.float64)
    img = np.clip(img + rng.randn(h, w, 3) * 12, 0, 255).astype(np.uint8)
    pts = (TEMPLATE * [w * 0.6, h * 0.8] + [w * 0.2, h * 0.1]).astype(int)
    for a, b in ((5, 7), (7, 9), (6, 8), (8, 10), (11, 13), (12, 14)):
        line3(img, pts[a], pts[b], (210, 60, 60))
    for x, y in pts:
        circle(img, x, y, 3, (60, 200, 60))
    return img


def codec_cases():
    """[(name, body)] of CODEC_CASES, encoded by the port's codec."""
    from offsetguided_tpu_torch.data import codec
    out = []
    for i, (name, sampling, q, rst, grey, (h, w)) in enumerate(CODEC_CASES):
        img = codec_image(h, w, seed=i)
        if grey:
            img = img[:, :, 1]
        body = (codec.encode_png(img) if sampling is None else
                codec.encode_jpeg(img, q, sampling, rst))
        out.append((name, body))
    return out


# The JAX package's optional transforms on seeded images, computed on the
# card's host without cv2: name -> the first 16 hex digits of the SHA-256
# of the output pixels, cv2's (cv2.GaussianBlur, the JAX package's
# jpeg_compression, cv2.imread), pinned on the CPU by
# tests/test_torch_port_transforms.py.
BLUR_SIZES = ((1, 1), (5, 7), (480, 640))
BLUR_SIGMAS = (0.3, 1.0, 2.0)
TRANSFORM_DIGESTS = {
    'blur 1x1x1 sigma 0.3': 'ee6bb86b44339392',
    'blur 1x1x1 sigma 1.0': 'ee6bb86b44339392',
    'blur 1x1x1 sigma 2.0': 'ee6bb86b44339392',
    'blur 1x1x3 sigma 0.3': '101f73216ee82d30',
    'blur 1x1x3 sigma 1.0': '101f73216ee82d30',
    'blur 1x1x3 sigma 2.0': '101f73216ee82d30',
    'blur 5x7x1 sigma 0.3': '7318fd16bd3d4033',
    'blur 5x7x1 sigma 1.0': 'a99b653a5a85dec9',
    'blur 5x7x1 sigma 2.0': 'a67172adf0e395ae',
    'blur 5x7x3 sigma 0.3': '2200d51605279b65',
    'blur 5x7x3 sigma 1.0': '72e3963d64c07485',
    'blur 5x7x3 sigma 2.0': '0e48917e93c0d6ac',
    'blur 480x640x1 sigma 0.3': 'a7a0fa96324ade43',
    'blur 480x640x1 sigma 1.0': 'e22549239a6ec4e8',
    'blur 480x640x1 sigma 2.0': '0ae8b4a0bc6ae6d9',
    'blur 480x640x3 sigma 0.3': '9f8b7706caf4a0d6',
    'blur 480x640x3 sigma 1.0': '029ad42065bddc41',
    'blur 480x640x3 sigma 2.0': '48df01238e8333a0',
    'jpeg_compression 480x640 seed 0': '2ea7b028f999c114',
    'ImageList jpeg exif 6': '66c92037cf12a858',
    'ImageList png': '1fb22acff0e974c5',
}


def exif_orientation_app1(orientation: int) -> bytes:
    """A big-endian EXIF APP1 segment holding one Orientation tag."""
    import struct
    tiff = (b'MM' + struct.pack('>HIH', 42, 8, 1)
            + struct.pack('>HHIHH', 0x0112, 3, 1, orientation, 0)
            + struct.pack('>I', 0))
    body = b'Exif\0\0' + tiff
    return b'\xff\xe1' + struct.pack('>H', len(body) + 2) + body


def transform_image(h: int, w: int, channels: int, seed: int) -> np.ndarray:
    """Seeded uint8 noise, (h, w) for one channel, else (h, w, 3)."""
    shape = (h, w) if channels == 1 else (h, w, 3)
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


def transform_files(root: str):
    """[(name, path)] of the files `ImageList` reads: a 4:2:0 JPEG (the
    port's encoder) with EXIF orientation 6 and a PNG, 97x153 scenes."""
    from offsetguided_tpu_torch.data import codec
    jpeg = codec.encode_jpeg(codec_image(97, 153, seed=8), 90)
    files = [('ImageList jpeg exif 6', os.path.join(root, 'o6.jpg'),
              jpeg[:2] + exif_orientation_app1(6) + jpeg[2:]),
             ('ImageList png', os.path.join(root, 'p.png'),
              codec.encode_png(codec_image(97, 153, seed=9)))]
    for _, path, body in files:
        with open(path, 'wb') as f:
            f.write(body)
    return [(name, path) for name, path, _ in files]


def transform_cases(root: str):
    """[(name, pixels)] of the port's `blur` kernel on every size, channel
    count and sigma of BLUR_SIZES x (1, 3) x BLUR_SIGMAS, its
    `jpeg_compression` on a 480x640 scene (quality drawn from seed 0), and
    `ImageList` on the files of `transform_files`."""
    from offsetguided_tpu_torch.data import pipeline, pixels
    from offsetguided_tpu_torch.data import transforms as T
    out = []
    for i, (h, w) in enumerate(BLUR_SIZES):
        for c in (1, 3):
            img = transform_image(h, w, c, seed=i)
            for sigma in BLUR_SIGMAS:
                out.append((f'blur {h}x{w}x{c} sigma {sigma}',
                            pixels.gaussian_blur_u8(img, sigma)))
    out.append(('jpeg_compression 480x640 seed 0', T.jpeg_compression(
        codec_image(480, 640, seed=7), np.random.RandomState(0))))
    names, paths = zip(*transform_files(root))
    images = pipeline.ImageList(paths)
    out += [(name, images.get(i)['image']) for i, name in enumerate(names)]
    return out


def pixel_digest(pixels: np.ndarray) -> str:
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(pixels).tobytes()
                          ).hexdigest()[:16]


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f'nvidia-smi: {out.stderr.strip()}')
    return out.stdout.strip().splitlines()[0]


def ptxas_lines(report: str):
    """ptxas -v report -> one line per kernel: its name (template argument
    included), stack frame, spills, registers and shared memory."""
    out, fn, props = [], None, []
    for ln in report.splitlines():
        m = re.search(r'Function properties for (\S+)', ln)
        if m:
            k = re.search(r'\d+([a-z][a-z_]*_kernel)(?:IL([bi])(\d+)E)?',
                          m[1])
            arg = None if not k or k[2] is None else (
                k[3] if k[2] == 'i' else 'true' if k[3] == '1' else 'false')
            fn = (k[1] + ('' if arg is None else f'<{arg}>')) if k else m[1]
        elif fn and ('stack frame' in ln or 'registers' in ln):
            props.append(ln.replace('ptxas info    :', '').strip())
            if 'registers' in ln:
                out.append(f'{fn}: ' + '; '.join(props))
                fn, props = None, []
    return out


def library_peaks(maps):
    """The fused peaks kernel's function in PyTorch calls on (M, h, w)
    maps: bicubic x4, 3x3 NMS by `max_pool2d`, `torch.topk`."""
    import torch
    import torch.nn.functional as F
    up = F.interpolate(maps[:, None], scale_factor=STRIDE, mode='bicubic',
                       align_corners=False)
    hmax = F.max_pool2d(F.pad(up, (1, 1, 1, 1)), 3, stride=1)
    nms = torch.where(hmax == up, up, torch.zeros_like(up))
    return torch.topk(nms.reshape(maps.shape[0], -1), TOPK)


def library_nms_topk(maps):
    """The NMS + top-k kernel's function in PyTorch calls on (M, h, w)
    maps: zero-padded 3x3 NMS by `max_pool2d`, `torch.topk`."""
    import torch
    import torch.nn.functional as F
    x = maps[:, None]
    hmax = F.max_pool2d(F.pad(x, (1, 1, 1, 1)), 3, stride=1)
    nms = torch.where(hmax == x, x, torch.zeros_like(x))
    return torch.topk(nms.reshape(maps.shape[0], -1), TOPK)


def phase_build():
    from offsetguided_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    _build.build_all(_build.SOURCES + _build.HOST_SOURCES)
    log(f'[build] {len(_build.SOURCES)} kernels and the host warp and codec '
        f'in {time.perf_counter() - t0:.1f} s (parallel nvcc for sm_90a, and '
        f'the host C++ compiler)')
    for name in _build.SOURCES:
        for ln in ptxas_lines(_build.build_logs.get(name, '')):
            log(f'[build] {name}.cu {ln}')


def phase_peaks(dev, skeleton, records):
    import torch
    from offsetguided_tpu_torch.ops.cuda import peaks

    b, h, w = N_IMG * J, LONG_EDGE // STRIDE, LONG_EDGE // STRIDE
    worst = 0.0
    for kind, x in peak_inputs(b, h, w, skeleton).items():
        maps = torch.from_numpy(x).to(dev)
        v, ys, xs = peaks.peaks_topk(maps, TOPK)
        pv, pys, pxs = peaks.peaks_topk_plain(maps, TOPK)
        torch.cuda.synchronize()
        if not (torch.equal(ys, pys) and torch.equal(xs, pxs)):
            bad = int((ys != pys).sum() + (xs != pxs).sum())
            fail(f'peaks kernel positions differ from plain on {kind} '
                 f'({bad} of {2 * ys.numel()})')
        err = float((v - pv).abs().max())
        worst = max(worst, err)
        log(f'[peaks] {kind}: ys/xs identical, vals bit-equal='
            f'{bool(torch.equal(v, pv))} max_abs_err={err:.3g}')
    if worst != 0.0:
        fail(f'peaks kernel values differ from plain by {worst}')

    maps = torch.from_numpy(peak_inputs(b, h, w, skeleton)['persons']).to(dev)
    ms = cuda_time(lambda: peaks.peaks_topk(maps, TOPK), 20)
    records['peaks'] = dict(
        name='peaks_topk', route='cuda',
        source='offsetguided_tpu_torch/csrc/peaks.cu',
        replaces='offsetguided_tpu/ops/pallas/peaks_pallas.py:199',
        max_abs_err=worst, ms_person_scenes=ms)
    log(f'[peaks] ({b}, {h}, {w}) k={TOPK} person heatmaps: kernel '
        f'{ms:.4f} ms')


CROWD_K, CROWD_CAPACITY = 96, 128


def crowd_case(dev):
    """A batch of dense crowds at capacity 128 and top-k 96, the JAX
    package's overflow-test shape: packed limbs on `dev` and their config."""
    import torch
    from offsetguided_tpu_torch.config.defaults import DecoderConfig
    x = torch.from_numpy(crowd_limbs(N_IMG, CROWD_K, seed=11)).to(dev)
    return x, DecoderConfig(topk=CROWD_K, dist_max=40.0, use_scale=False,
                            person_thre=0.05, max_poses=96,
                            capacity=CROWD_CAPACITY)


def grouping_barriers(src: str, n_limbs: int, settle: int) -> int:
    """Barriers one image passes in a grouping source: `limb_step`'s and
    `merge_pass`'s own `__syncthreads()` per limb (a step runs one merge
    pass), `merge_pass`'s per settle pass, and `group_kernel`'s own."""
    def own(name):
        m = re.search(r'void\s+(?:__launch_bounds__\([^)]*\)\s+)?'
                      + name + r'\(', src)
        if not m:
            raise ValueError(f'no definition of {name} in the source')
        i = src.index('{', m.end())
        depth, j = 0, i
        while True:
            depth += {'{': 1, '}': -1}.get(src[j], 0)
            if depth == 0:
                break
            j += 1
        return src[i:j].count('__syncthreads()')
    merge = own('merge_pass')
    return (n_limbs * (own('limb_step') + merge) + settle * merge
            + own('group_kernel'))


def compare_grouping(tag, x, skeleton, cfg, n_keypoints=J, order_free=False,
                     exact=False):
    """Kernel and plain grouping of `x` on the card: counts identical,
    scores within 1e-5, poses within 1e-4 place by place or, where
    `order_free`, as sets (the adversarial inputs tie person scores but for
    the order of the masked-mean sum, so tied poses may swap places); where
    `exact`, poses and scores bit-equal place by place. Logs whether the
    outputs, and the pose sets, are bit-equal; fails the run otherwise.
    On both sides every row past the kept ones, the ranks from the
    capacity on included, must be exactly zero. Returns the largest error
    the check allowed."""
    import torch
    from offsetguided_tpu_torch.ops import grouping as plain
    from offsetguided_tpu_torch.ops.cuda import grouping
    p, s, c = grouping.group_skeletons(x, skeleton, cfg, n_keypoints,
                                       cfg.capacity)
    rp, rs, rc = plain.group_skeletons(x, skeleton, cfg, n_keypoints,
                                       cfg.capacity)
    torch.cuda.synchronize()
    if not torch.equal(c, rc):
        fail(f'grouping counts differ on {tag}: {c.tolist()} vs {rc.tolist()}')
    n_rows = cfg.max_poses
    past = (torch.arange(n_rows, device=c.device)[None]
            >= c.clamp(max=n_rows)[:, None])
    for side, (poses, scores) in (('kernel', (p, s)), ('plain', (rp, rs))):
        if poses.shape[1] != n_rows or scores.shape[1] != n_rows:
            fail(f'grouping {side} output has {poses.shape[1]} rows on {tag}, '
                 f'not max_poses {n_rows}')
        if bool(poses[past].any()) or bool(scores[past].any()):
            fail(f'grouping {side} rows past the kept ones are not zero on '
                 f'{tag} (max_poses {n_rows}, capacity {cfg.capacity})')
    p_err = float((p - rp).abs().max())
    s_err = float((s - rs).abs().max())
    in_place = p_err <= 1e-4
    if not (s_err <= 1e-5 and (in_place or (
            order_free and pose_sets_match(p, rp, c, 1e-4)))):
        fail(f'grouping poses differ on {tag}: poses by {p_err}, scores by '
             f'{s_err}')
    same_sets = pose_sets_match(p, rp, c, 0.0)
    bit_equal = (torch.equal(bits(p), bits(rp))
                 and torch.equal(bits(s), bits(rs)))
    if exact and not bit_equal:
        fail(f'grouping outputs not bit-equal on {tag}: poses by {p_err}, '
             f'scores by {s_err}')
    log(f'{tag} {tuple(x.shape)} capacity {cfg.capacity}: counts '
        f'{c.tolist()} identical; poses max_abs_err {p_err:.3g} '
        f'{"in place" if in_place else "(as sets: within 1e-4)"}, scores '
        f'{s_err:.3g}; bit-equal {bit_equal}, pose sets bit-equal '
        f'{same_sets}')
    return max(s_err, p_err if in_place else 0.0 if same_sets else 1e-4)


def person_scene_limbs(dev, skeleton):
    """Packed limbs (8, 19, 32, 13) of 1-5 stick figures an image, decoded
    on `dev` from `person_maps`, and the decoder config that decoded them."""
    import torch
    from offsetguided_tpu_torch.config.defaults import DecoderConfig
    from offsetguided_tpu_torch.decoder import PostProcessor
    cfg = DecoderConfig(topk=TOPK, thre_hmp=0.04, dist_max=40.0)
    h = LONG_EDGE // STRIDE
    maps = person_maps(N_IMG, h, h, skeleton, seed=2)
    preds = {k: [torch.from_numpy(v).to(dev)] for k, v in maps.items()}
    return PostProcessor(cfg=cfg).decode_packed_limbs(preds).contiguous(), cfg


def phase_grouping(dev, skeleton, records):
    """The grouping kernel against its plain version on person scenes, the
    same with sentinels, a capacity-128 crowd and the JAX package's
    adversarial and overflow inputs."""
    import torch
    from offsetguided_tpu_torch.config.defaults import DecoderConfig
    from offsetguided_tpu_torch.ops.cuda import grouping

    packed, cfg = person_scene_limbs(dev, skeleton)
    if tuple(packed.shape) != (N_IMG, L, TOPK, 13):
        fail(f'packed limbs shape {tuple(packed.shape)}')
    worst = 0.0
    for kind, x in (('persons', packed), ('sentinels', with_sentinels(packed))):
        worst = max(worst, compare_grouping(f'[grouping] {kind}', x,
                                            skeleton, cfg))
    crowd, ccfg = crowd_case(dev)
    worst = max(worst, compare_grouping('[grouping] crowd', crowd, skeleton,
                                        ccfg))
    for kind, (x, sk, j, kw) in adversarial_cases().items():
        worst = max(worst, compare_grouping(
            f'[grouping] adversarial {kind} (max_poses {kw["max_poses"]})',
            torch.from_numpy(x).to(dev), sk, DecoderConfig(**kw), j,
            order_free=True))
    small = DecoderConfig(**CROWD_16_40)
    worst = max(worst, compare_grouping(
        '[grouping] crowd at capacity 16, max_poses 40',
        torch.from_numpy(crowd_limbs(N_IMG, small.topk, seed=16)).to(dev),
        skeleton, small))
    log('[grouping] max_poses above the capacity (the overflow input at 64 / '
        '96, crowd_40_64 at 64 / 96, a crowd at 16 / 40): counts identical, '
        'pose sets equal, rows past the kept ones zero on both sides')
    ms = cuda_time(lambda: grouping.group_skeletons(packed, skeleton, cfg), 20)
    src = open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            'offsetguided_tpu_torch', 'csrc',
                            'grouping.cu')).read()
    barriers = grouping_barriers(src, L, cfg.settle_passes)
    records['grouping'] = dict(
        name='group_skeletons', route='cuda',
        source='offsetguided_tpu_torch/csrc/grouping.cu',
        replaces='offsetguided_tpu/ops/pallas/grouping_pallas.py:476',
        max_abs_err=worst, ms_person_scenes=ms, barriers_per_image=barriers)
    log(f'[grouping] ({N_IMG}, {L}, {TOPK}, 13) 1-5 person scenes: kernel '
        f'{ms:.4f} ms; {barriers} barriers per image ({L} limbs, '
        f'{cfg.settle_passes} settle passes, counted from the source)')


def _wrappers():
    from offsetguided_tpu_torch.ops.cuda import grouping, nms_topk, peaks, topk
    return {'peaks': peaks.peaks_topk, 'grouping': grouping.group_skeletons,
            'topk': topk.topk, 'nms_topk': nms_topk.nms_topk}


def reset_launches():
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def check_launches(path: str, launches: dict, need, never=()) -> None:
    for name in need:
        if launches[name] == 0:
            fail(f'the {path} path never launched the {name} kernel: '
                 f'{launches}')
    for name in never:
        if launches[name] != 0:
            fail(f'the {path} path launched the {name} kernel: {launches}')


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper swapped for its plain version, also on CUDA
    tensors (the decode looks the wrappers up on their modules)."""
    from offsetguided_tpu_torch.ops import grouping as plain_grouping
    from offsetguided_tpu_torch.ops.cuda import grouping, nms_topk, peaks, topk
    swaps = [(peaks, 'peaks_topk', peaks.peaks_topk_plain),
             (topk, 'topk', topk.topk_plain),
             (nms_topk, 'nms_topk', nms_topk.nms_topk_plain),
             (grouping, 'group_skeletons', plain_grouping.group_skeletons)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def bits(t):
    """float32 tensor -> int32 bit patterns (-0.0 differs from +0.0)."""
    import torch
    return t.contiguous().view(torch.int32)


def phase_full_width(dev):
    """The main path: full-width Hourglass-104 serving at 640^2, batch 8,
    flip-test off and on, each path with its own launch counts (zeroed
    just before its 2 warm-up + 5 timed batches, read just after).
    Returns ({path: {kernel: launches}}, serve, images)."""
    import torch
    from offsetguided_tpu_torch.cli.serve import build_infer, cli
    from offsetguided_tpu_torch.eval.harness import make_infer_fn
    from offsetguided_tpu_torch.models import count_params

    rng = np.random.RandomState(7)
    images = torch.from_numpy(rng.randint(
        0, 256, (N_IMG, LONG_EDGE, LONG_EDGE, 3), dtype=np.uint8)).to(dev)
    serve = build_infer(cli([]), device=dev, seed=0)
    infers = {False: serve[0],
              True: make_infer_fn(serve[3], serve[0].postprocessor, True)}
    log(f'[full] Hourglass-104, {count_params(serve[3]) / 1e6:.1f} M '
        f'parameters, bf16 backbone, fp32 heads, BN folded')

    launches = {}
    for flip in (False, True):
        path = 'flip_on' if flip else 'flip_off'
        infer = infers[flip]
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        for _ in range(2):
            infer(images)
        torch.cuda.synchronize()
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            out = infer(images)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[path] = read_launches()
        poses, scores, counts = out
        if tuple(poses.shape) != (N_IMG, 40, J, 6):
            fail(f'{path}: poses shape {tuple(poses.shape)}')
        if not (torch.isfinite(poses).all() and torch.isfinite(scores).all()):
            fail(f'{path}: non-finite poses')
        log(f'[full] {path}: {N_IMG * iters / dt:.2f} img/s '
            f'(host clock, batch {N_IMG}, {LONG_EDGE}^2), counts '
            f'{counts.tolist()}, peak memory '
            f'{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB, '
            f'kernel launches {launches[path]}')
        check_launches(path, launches[path], ('peaks', 'grouping'),
                       never=('topk', 'nms_topk'))
        if int(counts.sum()) == 0:
            fail(f'no poses on the {path} path: grouping did no work')
    phase_profile(infers[False], images, 'one flip-off batch')
    return launches, serve, images


def phase_profile(infer, images, what='one flip-off batch'):
    """Device time of one batch by kernel, from torch.profiler:
    categories, the port's CUDA kernels, and the device's idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    infer(images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        infer(images)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    if not kernels:
        log('[profile] the profiler recorded no device time: not measured')
        return
    cats = {}
    for name, ms, _ in kernels:
        low = name.lower()
        if 'peaks_' in low or 'group_kernel' in low or 'topk_' in low:
            cat = 'CUDA kernels of the port'
        elif any(t in low for t in ('conv', 'gemm', 'xmma', 'cudnn', 'sm90',
                                    'cutlass', 'implicit', 'wgrad', 'dgrad')):
            cat = 'convolution / matmul'
        else:
            cat = 'other (decode glue, elementwise, copies)'
        cats[cat] = cats.get(cat, 0.0) + ms
    busy = sum(cats.values())
    log(f'[profile] {what}: wall {wall_ms:.2f} ms (profiler on), '
        f'device busy {busy:.2f} ms, idle share {1 - busy / wall_ms:.3f}')
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        log(f'[profile]   {cat}: {ms:.3f} ms ({ms / busy:.1%} of busy)')
    for name, ms, n in sorted(kernels, key=lambda r: -r[1])[:10]:
        log(f'[profile]   {ms:8.3f} ms  x{n:<4d} {name[:90]}')
    for name, ms, n in kernels:
        if 'peaks_' in name or 'group_kernel' in name or 'topk_' in name:
            log(f'[profile]   port kernel {name[:60]}: {ms:.4f} ms x{n}')


def phase_main_path_kernels(skeleton, serve, images, records):
    """Both kernels on the inputs the flip-off main path gives them (the
    full-width model's heatmaps, and the packed limbs decoded from them):
    held against their plain versions, and timed with the plain versions
    and, for peaks, the library chain. These launches are not counted."""
    import torch
    from offsetguided_tpu_torch.ops import grouping as plain
    from offsetguided_tpu_torch.ops.cuda import grouping, peaks
    from offsetguided_tpu_torch.ops.image import normalize_images

    infer, _, _, model = serve
    pp = infer.postprocessor
    cfg = pp.cfg
    with torch.inference_mode():
        preds = model(normalize_images(images))
        hmp = pp.select_stage(preds)['hmp']
        n, h, w, c = hmp.shape
        maps = hmp.permute(0, 3, 1, 2).reshape(n * c, h, w).contiguous()
        packed = pp.decode_packed_limbs(preds).contiguous()
    b = n * c

    v, ys, xs = peaks.peaks_topk(maps, TOPK)
    pv, pys, pxs = peaks.peaks_topk_plain(maps, TOPK)
    if not (torch.equal(ys, pys) and torch.equal(xs, pxs)):
        fail('peaks kernel positions differ from plain on the main path')
    err = float((v - pv).abs().max())
    if err != 0.0:
        fail(f'peaks kernel values differ from plain on the main path by {err}')

    ms = cuda_time(lambda: peaks.peaks_topk(maps, TOPK), 20)
    plain_ms = cuda_time(lambda: peaks.peaks_topk_plain(maps, TOPK), 5)
    lib_ms = cuda_time(lambda: library_peaks(maps), 10)
    split = launch_split(lambda: peaks.peaks_topk(maps, TOPK))
    H, W = h * STRIDE, w * STRIDE
    n_bytes = maps.numel() * 4 + b * TOPK * 12
    # per map: H pass 7 ops (4 mul + 3 add) per (full-res row, source col),
    # W pass 7 per pixel, 3x3 NMS 9 per pixel, block max + selection 4 per
    # 2x2 block
    n_ops = b * (7 * H * w + 16 * H * W + 4 * (H // 2) * (W // 2))
    records['peaks'].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound=(n_bytes, n_ops), **split)
    log(f'[main-path kernels] peaks ({b}, {h}, {w}) k={TOPK}: identical to '
        f'plain; kernel {ms:.4f} ms ({split_text(split)}), plain '
        f'{plain_ms:.4f} ms, interpolate+max_pool+topk {lib_ms:.4f} ms')

    err = compare_grouping('[main-path kernels] grouping', packed, skeleton,
                           cfg)
    r = records['grouping']
    r['max_abs_err'] = max(r['max_abs_err'], err)
    ms = cuda_time(lambda: grouping.group_skeletons(packed, skeleton, cfg), 20)
    plain_ms = cuda_time(
        lambda: plain.group_skeletons(packed, skeleton, cfg), 3, warmup=1)
    split = launch_split(lambda: grouping.group_skeletons(packed, skeleton,
                                                          cfg), parts=('group',))
    M, MP = cfg.capacity, cfg.max_poses
    n_bytes = packed.numel() * 4 + N_IMG * MP * (J * 6 + 1) * 4 + N_IMG * 4
    # per image and pass: dedup K^2, row matching 4MK, merge detection
    # M^2 J / 2 compares; 19 limb passes + settle merge passes
    passes = L + cfg.settle_passes
    n_ops = N_IMG * passes * (TOPK ** 2 + 4 * M * TOPK + M * M * J // 2)
    r.update(ms=ms, plain_ms=plain_ms, library_ms=None, bound=(n_bytes, n_ops),
             **split)
    log(f'[main-path kernels] grouping {tuple(packed.shape)}: kernel '
        f'{ms:.4f} ms ({split_text(split)}), plain {plain_ms:.4f} ms')

    crowd, ccfg = crowd_case(packed.device)
    r['max_abs_err'] = max(r['max_abs_err'], compare_grouping(
        '[main-path kernels] grouping crowd', crowd, skeleton, ccfg))
    crowd_ms = cuda_time(lambda: grouping.group_skeletons(
        crowd, skeleton, ccfg, capacity=ccfg.capacity), 20)
    crowd_plain_ms = cuda_time(lambda: plain.group_skeletons(
        crowd, skeleton, ccfg, J, ccfg.capacity), 3, warmup=1)
    r.update(ms_crowd_128=crowd_ms, plain_ms_crowd_128=crowd_plain_ms)
    log(f'[main-path kernels] grouping crowd {tuple(crowd.shape)} capacity '
        f'{ccfg.capacity}: kernel {crowd_ms:.4f} ms, plain '
        f'{crowd_plain_ms:.4f} ms')


def phase_reference(dev, model_serve):
    """What comes out is right: (a) the full-width fp32 forward on the card
    equals the CPU forward on a small input; (b) the card's decode of the
    full-width maps equals the plain CPU decode of the same maps."""
    import torch
    from offsetguided_tpu_torch.config.defaults import ModelConfig
    from offsetguided_tpu_torch.device import disable_tf32
    from offsetguided_tpu_torch.models import random_posenet
    from offsetguided_tpu_torch.ops.image import normalize_images

    disable_tf32()
    size = 256                       # calibrated and compared at one size
    net = random_posenet(ModelConfig(compute_dtype='float32'), 0, device=dev,
                         calib_size=size)
    net = net.cpu()
    x = normalize_images(torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, (1, size, size, 3), dtype=np.uint8)))
    with torch.inference_mode():
        ref = net(x)['hmp'][-1]
        got = net.to(dev)(x.to(dev))['hmp'][-1].cpu()
    del net
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    log(f'[reference] fp32 forward card vs CPU at {size}^2: max_abs_err '
        f'{err:.3g} (max |hmp| {scale:.3g})')
    if not err <= 1e-3 * scale:
        fail(f'card forward differs from CPU by {err} (scale {scale})')
    torch.backends.cudnn.allow_tf32 = True

    infer, _, _, model = model_serve
    pp = infer.postprocessor
    images = torch.from_numpy(np.random.RandomState(7).randint(
        0, 256, (N_IMG, LONG_EDGE, LONG_EDGE, 3), dtype=np.uint8)).to(dev)
    with torch.inference_mode():
        preds = model(normalize_images(images))
        p, s, c = pp.decode_body(preds)
        cpu = {k: [None if t is None else t.cpu() for t in v]
               for k, v in preds.items()}
        rp, rs, rc = pp.decode_body(cpu)
    if not torch.equal(c.cpu(), rc):
        fail(f'card decode counts {c.tolist()} vs CPU {rc.tolist()}')
    err = float((p.cpu() - rp).abs().max())
    log(f'[reference] decode of the full-width maps, card kernels vs CPU '
        f'plain: counts {rc.tolist()} identical, poses max_abs_err {err:.3g}')
    if not err <= 1e-3:
        fail(f'card decode differs from CPU by {err}')


def phase_batcher(dev, model_serve):
    import torch
    from offsetguided_tpu_torch.cli.serve import Batcher
    from offsetguided_tpu_torch.eval.harness import preprocess_eval

    infer, _, ecfg, _ = model_serve
    reset_launches()
    batcher = Batcher(infer, ecfg.batch_size, 5.0, dev)
    rng = np.random.RandomState(11)
    shapes = [(480, 640), (640, 427), (375, 500), (333, 500), (640, 640),
              (427, 640), (512, 384), (360, 640), (640, 480), (500, 375),
              (240, 320), (600, 800)]
    images = [rng.randint(0, 256, s + (3,), dtype=np.uint8) for s in shapes]
    results, lat = [None] * len(shapes), [None] * len(shapes)
    errors = []

    def request(i):
        try:
            t0 = time.perf_counter()
            x, _, meta = preprocess_eval(
                images[i], np.zeros((0, J, 4), np.float32), ecfg)
            results[i] = batcher.submit(x, meta, timeout=120.0)
            lat[i] = time.perf_counter() - t0
        except Exception as e:  # reported below; the phase then fails
            errors.append(repr(e))

    threads = [threading.Thread(target=request, args=(i,))
               for i in range(len(shapes))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
    finally:
        batcher.close()
    torch.cuda.synchronize()
    if errors or any(t.is_alive() for t in threads):
        fail(f'batcher requests failed: {errors[:3]}')
    if any(r is None or r.shape[1:] != (J, 6) or len(r) == 0
           for r in results):
        fail('a batcher request got no poses')
    launches = read_launches()
    check_launches('batcher', launches, ('peaks', 'grouping'))
    m = batcher.metrics()
    log(f'[batcher] {len(shapes)} concurrent requests of mixed sizes: all '
        f'answered, poses per request {[len(r) for r in results]}, '
        f'p50 latency {np.median(lat) * 1e3:.1f} ms (host preprocess + '
        f'queue + batch), device-batch p50 '
        f'{m["device_batch_latency_ms"]["p50"]:.1f} ms over '
        f'{m["batches"]} batches, kernel launches {launches}')
    return launches


def fixed_height_images(n: int, seed: int):
    """`n` seeded 480x640 noise images through the fixed-height evaluator's
    preprocessing: (n, 640, 1024, 3) uint8."""
    from offsetguided_tpu_torch.config.defaults import EvalConfig
    from offsetguided_tpu_torch.eval.harness import preprocess_eval
    rng = np.random.RandomState(seed)
    cfg = EvalConfig(long_edge=LONG_EDGE, fixed_height=True)
    return np.stack([preprocess_eval(
        rng.randint(0, 256, (480, 640, 3), dtype=np.uint8),
        np.zeros((0, J, 4), np.float32), cfg)[0] for _ in range(n)])


def phase_topk(dev, serve, records):
    """The block top-k kernel on the fixed-height route's own input: the
    2x2 block maxima of the NMS'd x4 heatmaps of the full-width model at
    640x1024, batch 8, (136, 320, 512), k=32; and on three variants of it
    (1/8-quantized, mostly zero, with -0.0). Timed with its plain version,
    torch.topk, the whole route, and the fused peaks kernel on the same
    rectangular maps; then forward, decode and a profile of one
    fixed-height flip-on batch."""
    import torch
    import torch.nn.functional as F
    from offsetguided_tpu_torch.config.defaults import DecoderConfig
    from offsetguided_tpu_torch.decoder import PostProcessor
    from offsetguided_tpu_torch.eval.harness import make_infer_fn
    from offsetguided_tpu_torch.ops import decoder as dec
    from offsetguided_tpu_torch.ops.cuda import peaks, topk
    from offsetguided_tpu_torch.ops.image import normalize_images
    from offsetguided_tpu_torch.ops.resize import upsample2d

    model = serve[3]
    images = torch.from_numpy(fixed_height_images(N_IMG, 5)).to(dev)
    with torch.inference_mode():
        hmp = model(normalize_images(images))['hmp'][-1]       # (8, 160, 256, 17)
        n, h, w, c = hmp.shape
        nmsed = dec.hmp_nms(upsample2d(hmp, STRIDE, 'bicubic'))
        bm = F.max_pool2d(nmsed.permute(0, 3, 1, 2), 2, stride=2)
        m, hb, wb = n * c, bm.shape[2], bm.shape[3]
        bm = bm.reshape(m, hb * wb).contiguous()
        maps = hmp.permute(0, 3, 1, 2).reshape(m, h, w).contiguous()
    g = torch.Generator(device=dev).manual_seed(0)
    sparse = torch.where(torch.rand(bm.shape, generator=g, device=dev) < 1e-4,
                         bm, torch.zeros((), device=dev))
    col = torch.arange(bm.shape[1], device=dev) % 2 == 0
    inputs = {
        'model': bm,
        'eighths': torch.round(bm * 8) / 8,
        'mostly_zero': sparse,
        'neg_zero': torch.where((sparse == 0) & col, -0.0, sparse),
    }
    for kind, x in inputs.items():
        v, i = topk.topk(x, TOPK)
        pv, pi = topk.topk_plain(x, TOPK)
        torch.cuda.synchronize()
        if not (torch.equal(i, pi) and torch.equal(bits(v), bits(pv))):
            fail(f'topk kernel differs from plain on {kind}: '
                 f'{int((i != pi).sum())} indices of {i.numel()}')
        log(f'[topk] {kind} ({m}, {hb}x{wb}) k={TOPK}: vals bit-equal, '
            f'inds identical')

    # kernel and torch.topk in turns: kernel, library, library, kernel
    turns = [cuda_time(fn, 20) for fn in (
        lambda: topk.topk(bm, TOPK), lambda: torch.topk(bm, TOPK),
        lambda: torch.topk(bm, TOPK), lambda: topk.topk(bm, TOPK))]
    ms, lib_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    plain_ms = cuda_time(lambda: topk.topk_plain(bm, TOPK), 5)
    split = launch_split(lambda: topk.topk(bm, TOPK))
    fused_ms = cuda_time(lambda: peaks.peaks_topk(maps, TOPK), 20)
    # the whole route the fused kernel would replace on these rectangles
    with torch.inference_mode():
        route_ms = cuda_time(lambda: dec.topk_channel_blockreduce(
            dec.hmp_nms(upsample2d(hmp, STRIDE, 'bicubic')), TOPK), 5)
    # the fused kernel on the same rectangles: same peaks as the route?
    with torch.inference_mode():
        sv, _, sy, sx = dec.topk_channel_blockreduce(nmsed, TOPK)
    fv, fy, fx = peaks.peaks_topk(maps, TOPK)
    same = (torch.equal(sy.reshape(m, TOPK), fy)
            and torch.equal(sx.reshape(m, TOPK), fx)
            and torch.equal(bits(sv.reshape(m, TOPK)), bits(fv)))
    n_bytes = bm.numel() * 4 + m * TOPK * 8
    n_ops = bm.numel()          # one key build + compare per element
    records['topk'] = dict(
        name='topk', route='cuda',
        source='offsetguided_tpu_torch/csrc/topk.cu',
        replaces='offsetguided_tpu/ops/pallas/topk_pallas.py:19',
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        fused_peaks_ms=fused_ms, route_ms=route_ms, bound=(n_bytes, n_ops),
        **split)
    log(f'[topk] ({m}, {hb}x{wb}) k={TOPK}: kernel {ms:.4f} ms '
        f'({split_text(split)}; turns {[round(t, 4) for t in turns[::3]]}), '
        f'torch.topk {lib_ms:.4f} ms (turns '
        f'{[round(t, 4) for t in turns[1:3]]}), kernel faster than '
        f'torch.topk: {ms < lib_ms}; plain {plain_ms:.4f} ms')
    log(f'[topk] the route (upsample '
        f'+ NMS + block max + kernel + gather) {route_ms:.4f} ms; fused peaks '
        f'kernel on the same ({m}, {h}, {w}) heatmaps {fused_ms:.4f} ms, same '
        f'peaks as the route: {same}')

    # where the time goes on the fixed-height path: one flip-on batch
    pp = PostProcessor(cfg=DecoderConfig(topk=TOPK, thre_hmp=0.04,
                                         dist_max=40.0))
    with torch.inference_mode():
        x = normalize_images(images)
        x = torch.cat([x, torch.flip(x, dims=(2,))])
        fwd_ms = cuda_time(lambda: model(x), 5)
        preds = model(x)
        dec_ms = cuda_time(lambda: pp.decode_body(preds, flip_test=True), 5)
    log(f'[topk] fixed-height flip-on batch ({N_IMG} x 640x1024): forward '
        f'{fwd_ms:.3f} ms, decode (flip merge, upsample, NMS, block top-k, '
        f'limbs, grouping) {dec_ms:.3f} ms')
    phase_profile(make_infer_fn(model, pp, True), images,
                  f'one fixed-height flip-on batch ({N_IMG} x 640x1024)')


def phase_nms_topk(dev, serve, records):
    """The NMS + top-k kernel at (136, 160, 160) and (136, 160, 256) on
    random^4, quantized and one-NaN maps, and on the stride-resolution
    route's own input (the full-width model's 640x640 heatmaps, the
    (8, 160, 160, 17) channel slice of the head output, copied into
    (136, 160, 160) maps as the route does): identical to its plain
    version, timed with it, with max_pool2d NMS + torch.topk, and as the
    route runs it (the copy + the kernel + the index math)."""
    import torch
    from offsetguided_tpu_torch.ops.cuda import nms_topk
    from offsetguided_tpu_torch.ops.image import normalize_images

    rng = np.random.RandomState(9)
    m = N_IMG * J
    for w in (160, 256):
        x = rng.rand(m, 160, w).astype(np.float32)
        nan = x.copy()
        nan[3, 80, w // 2] = np.nan
        for kind, arr in (('pow4', x ** 4),
                          ('quantized', np.round(x * 8) / 8), ('nan', nan)):
            t = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(dev)
            v, i = nms_topk.nms_topk(t, TOPK)
            pv, pi = nms_topk.nms_topk_plain(t, TOPK)
            torch.cuda.synchronize()
            if not (torch.equal(i, pi) and torch.equal(bits(v), bits(pv))):
                fail(f'nms_topk kernel differs from plain on {kind} '
                     f'({m}, 160, {w}): {int((i != pi).sum())} indices')
            log(f'[nms_topk] {kind} ({m}, 160, {w}) k={TOPK}: identical')

    images = torch.from_numpy(np.random.RandomState(7).randint(
        0, 256, (N_IMG, LONG_EDGE, LONG_EDGE, 3), dtype=np.uint8)).to(dev)
    with torch.inference_mode():
        hmp = serve[3](normalize_images(images))['hmp'][-1]
    n, h, w, c = hmp.shape
    maps = hmp.permute(0, 3, 1, 2).reshape(n * c, h, w)   # as the route does
    pv, pi = nms_topk.nms_topk_plain(maps, TOPK)
    v, i = nms_topk.nms_topk(maps, TOPK)
    torch.cuda.synchronize()
    if not (torch.equal(i, pi) and torch.equal(bits(v), bits(pv))):
        fail('nms_topk kernel differs from plain on the model heatmaps')
    log(f'[nms_topk] model heatmaps {tuple(hmp.shape)} stride {hmp.stride()}'
        f': identical to plain')

    def route():                                 # as ops/decoder.py runs it
        x = hmp.permute(0, 3, 1, 2).reshape(n * c, h, w)
        vals, flat = nms_topk.nms_topk(x, TOPK)
        inds = flat.reshape(n, c, TOPK)
        return vals.reshape(n, c, TOPK), inds // w, inds % w

    ms = cuda_time(lambda: nms_topk.nms_topk(maps, TOPK), 20)
    plain_ms = cuda_time(lambda: nms_topk.nms_topk_plain(maps, TOPK), 5)
    lib_ms = cuda_time(lambda: library_nms_topk(maps), 20)
    with torch.inference_mode():
        route_ms = cuda_time(route, 20)
        copy_ms = cuda_time(lambda: hmp.permute(0, 3, 1, 2).reshape(
            n * c, h, w), 20)
    split = launch_split(lambda: nms_topk.nms_topk(maps, TOPK),
                         parts=('nms_topk',))
    n_bytes = maps.numel() * 4 + n * c * TOPK * 12
    n_ops = 10 * maps.numel()   # 9-cell max + compare per cell
    records['nms_topk'] = dict(
        name='nms_topk', route='cuda',
        source='offsetguided_tpu_torch/csrc/nms_topk.cu',
        replaces='offsetguided_tpu/ops/pallas/nms_topk_pallas.py:20',
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        route_ms=route_ms, route_copy_ms=copy_ms,
        bound=(n_bytes, n_ops), **split)
    log(f'[nms_topk] model heatmaps ({n * c}, {h}, {w}) k={TOPK}: kernel '
        f'{ms:.4f} ms ({split_text(split)}), plain {plain_ms:.4f} ms, '
        f'max_pool2d NMS + torch.topk {lib_ms:.4f} ms')
    log(f'[nms_topk] the route (the (N*C, h, w) copy + kernel + index math) '
        f'{route_ms:.4f} ms, the copy alone {copy_ms:.4f} ms')


def phase_large_k(dev):
    """The three selection kernels at k = 1024 against their plain versions
    (k past the 512 their wrappers once refused)."""
    import torch
    from offsetguided_tpu_torch.ops.cuda import nms_topk, peaks, topk
    rng = np.random.RandomState(13)
    k = 1024
    x = torch.from_numpy((np.round(rng.rand(J, 20000) * 64) / 64)
                         .astype(np.float32)).to(dev)
    v, i = topk.topk(x, k)
    pv, pi = topk.topk_plain(x, k)
    ok = torch.equal(i, pi) and torch.equal(bits(v), bits(pv))
    maps = torch.from_numpy(rng.rand(J, 40, 40).astype(np.float32) ** 4).to(dev)
    v, ys, xs = peaks.peaks_topk(maps, k)
    pv, pys, pxs = peaks.peaks_topk_plain(maps, k)
    ok = ok and torch.equal(ys, pys) and torch.equal(xs, pxs) and \
        torch.equal(bits(v), bits(pv))
    v, i = nms_topk.nms_topk(maps, k)
    pv, pi = nms_topk.nms_topk_plain(maps, k)
    torch.cuda.synchronize()
    ok = ok and torch.equal(i, pi) and torch.equal(bits(v), bits(pv))
    if not ok:
        fail(f'a selection kernel differs from its plain version at k={k}')
    log(f'[large-k] k={k}: topk ({J}, 20000), peaks ({J}, 40, 40) and '
        f'nms_topk ({J}, 40, 40) identical to their plain versions')


def phase_evaluate(dev, root):
    """`cli.evaluate.main` at full width over 16 seeded .npy images in the
    hard set's shapes: fixed height with flip-test, then stride-resolution
    decode; each path with its own launch counts."""
    import torch
    from offsetguided_tpu_torch.cli import evaluate
    from offsetguided_tpu_torch.data.synthetic import make_hard_dataset

    img_dir, ann = make_hard_dataset(os.path.join(root, 'eval'),
                                     n_images=16, seed=3, ext='npy')
    base = ['--image-dir', img_dir, '--annotation-file', ann,
            '--batch-size', str(N_IMG), '--all-images']
    paths = {
        'eval_fixed_height': (['--fixed-height', '--flip-test'],
                              ('topk', 'grouping'), ('peaks', 'nms_topk')),
        'eval_lowres': (['--lowres-decode'], ('nms_topk', 'grouping'),
                        ('peaks', 'topk')),
    }
    launches = {}
    for path, (extra, need, never) in paths.items():
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        stats = evaluate.main(base + extra)
        torch.cuda.synchronize()
        launches[path] = read_launches()
        if not all(np.isfinite(v) for v in stats.values()):
            fail(f'{path}: non-finite metrics {stats}')
        log(f'[evaluate] {path}: 16 images, {stats["img_per_s"]:.2f} img/s '
            f'(host clock, batch {N_IMG}, IO + preprocess + forward + '
            f'decode), AP {stats["AP"]:.4f} (random weights), peak memory '
            f'{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB, '
            f'kernel launches {launches[path]}')
        check_launches(path, launches[path], need, never)
    return launches


def records_by_image(poses, counts, metas, ids):
    from offsetguided_tpu_torch.data import transforms as T
    from offsetguided_tpu_torch.eval.harness import poses_to_coco_results
    poses, counts = poses.cpu().numpy(), counts.cpu().numpy()
    out = {}
    for b, img_id in enumerate(ids):
        inv = T.annotations_inverse(poses[b][:int(counts[b])], metas[b])
        out[img_id] = {(tuple(np.round(r['keypoints'], 2)),
                        round(r['score'], 4))
                       for r in poses_to_coco_results(inv, img_id)}
    return out


def phase_oracle(dev, root):
    """`cli.simulate.main` on the 100-image hard annotations, upsampled and
    stride-resolution decode, against the JAX package's APs (within
    0.002); then one fixed-height batch of encoded GT decoded through the
    kernels and through the plain versions on the card."""
    import torch
    from offsetguided_tpu_torch.cli import simulate
    from offsetguided_tpu_torch.config.defaults import (
        DecoderConfig, EncoderConfig, EvalConfig, SkeletonConfig)
    from offsetguided_tpu_torch.data import synthetic
    from offsetguided_tpu_torch.data import transforms as T
    from offsetguided_tpu_torch.data.coco import CocoJson
    from offsetguided_tpu_torch.decoder import PostProcessor
    from offsetguided_tpu_torch.eval.harness import preprocess_eval
    from offsetguided_tpu_torch.ops.encoder import encode_targets

    ann = synthetic.write_annotations(os.path.join(root, 'oracle'),
                                      synthetic.hard_annotations(100, seed=0))
    launches = {}
    paths = {'upsampled': ([], ('peaks', 'grouping')),
             'lowres': (['--lowres-decode'], ('nms_topk', 'grouping'))}
    for name, (extra, need) in paths.items():
        reset_launches()
        t0 = time.perf_counter()
        stats = simulate.main(['--annotation-file', ann] + ORACLE_ARGS + extra)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        path = f'oracle_{name}'
        launches[path] = read_launches()
        ap, want = stats['AP'], ORACLE_AP[name]
        log(f'[oracle] {name} decode, 100 images: AP {ap:.4f} (JAX CPU f32 '
            f'{want:.4f}), APm {stats["APm"]:.4f}, APl {stats["APl"]:.4f}, '
            f'{dt:.1f} s, kernel launches {launches[path]}')
        check_launches(path, launches[path], need)
        if not abs(ap - want) <= 0.002:
            fail(f'oracle {name} AP {ap:.4f} is not within 0.002 of {want}')

    # one fixed-height shape: the images that pad to 640x1024
    skeleton = SkeletonConfig()
    coco = CocoJson(ann)
    ecfg = EvalConfig(long_edge=LONG_EDGE, fixed_height=True)
    enc = EncoderConfig(max_persons=16)
    padded, metas, ids = [], [], []
    for img_id in coco.image_ids(with_persons=True, with_keypoints=True):
        if len(ids) == N_IMG:
            break
        info = coco.image_info(img_id)
        anns = T.normalize_annotations(coco.anns_for_image(img_id),
                                       skeleton.sigmas)
        img, anns, meta = preprocess_eval(
            np.zeros((info['height'], info['width'], 3), np.uint8), anns, ecfg)
        if img.shape[:2] != (LONG_EDGE, 1024):
            continue
        p = np.zeros((enc.max_persons, J, 4), np.float32)
        p[:min(len(anns), enc.max_persons)] = anns[:enc.max_persons]
        padded.append(p)
        metas.append(meta)
        ids.append(img_id)
    pp = PostProcessor(skeleton=skeleton, cfg=DecoderConfig(
        topk=TOPK, thre_hmp=0.04, dist_max=40.0, use_scale=False,
        person_thre=0.1))
    with torch.inference_mode():
        t = encode_targets(torch.from_numpy(np.stack(padded)).to(dev),
                           skeleton.sigmas, skeleton.skeleton,
                           LONG_EDGE // STRIDE, 1024 // STRIDE, enc)
        preds = {'hmp': [t.hmp], 'jomp': [t.jomp], 'omp': [t.omp],
                 'scmp': [None]}
        reset_launches()
        kp, _, kc = pp.decode_body(preds)
        torch.cuda.synchronize()
        used = read_launches()
        with plain_kernels():
            rp, _, rc = pp.decode_body(preds)
    check_launches('oracle fixed-height kernel route', used,
                   ('topk', 'grouping'), never=('peaks', 'nms_topk'))
    ours = records_by_image(kp, kc, metas, ids)
    plain = records_by_image(rp, rc, metas, ids)
    if ours != plain:
        bad = [i for i in ids if ours[i] != plain[i]]
        fail(f'fixed-height GT decode: kernel and plain records differ on '
             f'images {bad}')
    log(f'[oracle] fixed height 640x1024, {len(ids)} GT images: kernel route '
        f'(launches {used}) and plain route give identical record sets '
        f'({sum(len(v) for v in ours.values())} records)')
    return launches


# the [train] phase: the JAX trainer's CLI defaults at full width
TRAIN_BATCH, TRAIN_SIZE, TRAIN_STEPS, TRAIN_IMAGES = 16, 512, 12, 64
TRAIN_REMAT = False      # batch 16 fits the card without remat
# the one-step card-vs-CPU check: tests/test_torch_port_train.py's tiny
# model, batch and tolerances (gradients rtol 1e-3 with atol 1e-4 of the
# largest, BN statistics 1e-5, losses 1e-4 relative)
TINY_TRAIN = dict(n_stacks=1, hg_order=2, dims=(16, 16, 24),
                  modules=(1, 1, 1), cnv_dim=16, compute_dtype='float32')


def phase_train(dev, root, skeleton, records):
    """`cli.train.main` on the card at full width (Hourglass-104, bf16
    autocast, fp32 parameters and BatchNorm statistics, Adam) on the
    64-image hard set: 512^2, batch 16, 12 steps. Checks finite losses, no
    skipped step, a falling heatmap loss and a checkpoint; prints train
    img/s (host clock over steps 3-12, each step ending in a sync), the
    step split by CUDA events, host wait and peak memory. Then serves the
    checkpoint (the hand-off): its launches are the `train_handoff` path.
    Returns {'train_handoff': launches}."""
    import torch
    from offsetguided_tpu_torch.cli import train
    from offsetguided_tpu_torch.data.synthetic import make_hard_dataset

    img_dir, ann = make_hard_dataset(os.path.join(root, 'train'),
                                     n_images=TRAIN_IMAGES, seed=0, ext='npy')
    ckpt_dir = os.path.join(root, 'checkpoints')
    argv = ['--device-aug', '--train-image-dir', img_dir,
            '--train-annotations', ann, '--batch-size', str(TRAIN_BATCH),
            '--square-length', str(TRAIN_SIZE), '--max-steps',
            str(TRAIN_STEPS), '--print-freq', '1', '--checkpoint-dir',
            ckpt_dir] + (['--remat'] if TRAIN_REMAT else [])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    r = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if any(read_launches().values()):
        fail(f'training launched a decode kernel: {read_launches()}')
    hist = r['history']
    for h in hist:
        log(f'[train] step {h["step"]}: total {h["total"]:.4f} hmp '
            f'{h["hmp"]:.4f} omp {h["omp"]:.6f} scmp {h["scmp"]:.4f} '
            f'skipped {h["skipped"]:.0f}, host wait {h["host_wait_s"]:.4f} '
            f's, feed {h["feed_ms"]:.2f} ms, forward+backward+optimizer '
            f'{h["step_ms"]:.2f} ms (CUDA events)')
    train_summary('train', hist, wall, peak, r['checkpoint'])
    gaps = sorted(b['t'] - a['t'] for a, b in zip(hist[1:], hist[2:]))
    phase_train_profile(dev, img_dir, ann, gaps[len(gaps) // 2] * 1e3)
    return {'train_handoff': phase_train_handoff(
        dev, r['checkpoint'], r['model_cfg'], skeleton, records)}


H2D_RUNS = 4                 # the feed's H2D per route, in turns; 1 warm-up


def phase_train_profile(dev, img_dir, ann, step_ms):
    """Where a training step's time goes, at the [train] configuration:
    the host loader's batch (host clock), the feed split by CUDA events
    (H2D from pinned memory, the warp + photometric + annotation pass on
    the tiled warp, the trainer's default, and on the patch warp, GT
    encoding, mask downscaling; mean of 3 batches after one warm-up), the
    H2D of each route's batch as the trainer puts it (`cli.train.
    device_batch`: each array pinned, then copied without blocking) in
    turns, device-aug and host route, against `step_ms` (the [train]
    run's median step, host clock), and one train step under
    torch.profiler by kernel category, with the device's idle share, for
    Hourglass-104 and for the 4-stage net (2 stacks, the JAX CLI's
    default)."""
    import torch
    from offsetguided_tpu_torch.config.defaults import (
        AugmentationConfig, EncoderConfig, ModelConfig, SkeletonConfig)
    from offsetguided_tpu_torch.data import pipeline
    from offsetguided_tpu_torch.ops.augment import (augment_batch_dict,
                                                    warp_slope_bound)
    from offsetguided_tpu_torch.ops.encoder import (downscale_mask,
                                                    encode_targets)

    sk = SkeletonConfig()
    enc = EncoderConfig()
    aug = AugmentationConfig(square_length=TRAIN_SIZE)
    ds = pipeline.CocoKeypoints(img_dir, ann, aug=aug,
                                square_length=TRAIN_SIZE, device_aug=True)
    t0 = time.perf_counter()
    batches = [pipeline._make_batch(ds, range(i * TRAIN_BATCH,
                                              (i + 1) * TRAIN_BATCH),
                                    pipeline._batch_rng(0, 0, i), 0)
               for i in range(H2D_RUNS)]
    loader_ms = (time.perf_counter() - t0) / H2D_RUNS * 1e3
    out_hw = TRAIN_SIZE // enc.stride
    parts = {'h2d': 0.0, 'augment (tiled warp)': 0.0,
             'augment (patch warp)': 0.0, 'encode': 0.0, 'downscale': 0.0}
    for i, batch in enumerate(batches):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        b = {k: torch.from_numpy(batch[k]).pin_memory().to(
            dev, non_blocking=True) for k in ds.sample_spec()}
        ev[1].record()
        with torch.no_grad():
            imgs, mask01, anns = augment_batch_dict(
                b, TRAIN_SIZE, ds.left_index, ds.right_index,
                slope_bound=warp_slope_bound(ds.aug))
            ev[2].record()
            augment_batch_dict(b, TRAIN_SIZE, ds.left_index, ds.right_index,
                               warp_impl='patch')
            ev[3].record()
            targets = encode_targets(anns, sk.sigmas, sk.skeleton, out_hw,
                                     out_hw, enc)
            ev[4].record()
            mask = downscale_mask(mask01, enc)
            ev[5].record()
        torch.cuda.synchronize()
        if i:
            for k, (a, c) in zip(parts, zip(ev, ev[1:])):
                parts[k] += a.elapsed_time(c) / (H2D_RUNS - 1)
    log(f'[train profile] host loader {loader_ms:.1f} ms a batch of '
        f'{TRAIN_BATCH} (one thread, host clock); feed by CUDA events: '
        + ', '.join(f'{k} {v:.2f} ms' for k, v in parts.items()))

    host_ds = pipeline.CocoKeypoints(img_dir, ann, aug=aug,
                                     square_length=TRAIN_SIZE)
    routes = {'device-aug': (ds, batches), 'host': (host_ds, [
        {k: v for k, v in pipeline._make_batch(
            host_ds, range(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH),
            pipeline._batch_rng(0, 0, i), 0).items()
         if k in ('image', 'anns', 'mask_miss')} for i in range(H2D_RUNS)])}
    h2d = {r: [] for r in routes}
    for i in range(H2D_RUNS):
        for route, (d, bs) in routes.items():
            keys = d.sample_spec() if route == 'device-aug' else bs[i]
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            on_dev = [torch.from_numpy(bs[i][k]).pin_memory().to(
                dev, non_blocking=True) for k in keys]
            ev[1].record()
            torch.cuda.synchronize()
            if i:
                h2d[route].append(ev[0].elapsed_time(ev[1]))
            del on_dev
    for route, (d, bs) in routes.items():
        keys = d.sample_spec() if route == 'device-aug' else bs[0]
        mb = sum(bs[0][k].nbytes for k in keys) / 1e6
        ms = sorted(h2d[route])
        med = ms[len(ms) // 2]
        log(f'[train profile] H2D {route} route, batch {TRAIN_BATCH} at '
            f'{TRAIN_SIZE}^2 ({mb:.1f} MB in {len(keys)} arrays, pinned '
            f'then copied, CUDA events, {len(ms)} runs in turns): '
            f'{", ".join(f"{v:.3f}" for v in h2d[route])} ms, median '
            f'{med:.3f} ms = {med / step_ms:.2%} of the [train] median step '
            f'({step_ms:.1f} ms) | {card_line()}')

    for tag, cfg in (('Hourglass-104', ModelConfig()), (
            'Hourglass-4stage', ModelConfig(basenet='hourglass4stage'))):
        profile_train_step(dev, tag, cfg, imgs, targets, mask)


def profile_train_step(dev, tag, cfg, imgs, targets, mask):
    """One train step (forward + backward + Adam, `init_reference_`
    weights, after two) of `cfg` on a fed batch under torch.profiler: wall
    and busy ms, the device's idle share, and device time by kernel
    category."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from offsetguided_tpu_torch.config.defaults import (LossConfig,
                                                        TrainConfig)
    from offsetguided_tpu_torch.models import PoseNet
    from offsetguided_tpu_torch.models.network import init_reference_
    from offsetguided_tpu_torch.parallel.train_step import (TrainStep,
                                                            make_optimizer)
    model = init_reference_(PoseNet(cfg), torch.Generator().manual_seed(0))
    model = model.to(dev, memory_format=torch.channels_last)
    step = TrainStep(model, make_optimizer(TrainConfig(), model.parameters()),
                     LossConfig(stack_weights=(1.0,) * cfg.n_stacks))
    for _ in range(2):
        step(imgs, targets, mask)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(imgs, targets, mask)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    if not kernels:
        log(f'[train profile] {tag}: the profiler recorded no device time: '
            f'not measured')
        return
    cats = {}
    for name, ms, _ in kernels:
        low = name.lower()
        if any(t in low for t in ('conv', 'gemm', 'xmma', 'cudnn', 'sm90',
                                  'cutlass', 'implicit', 'wgrad', 'dgrad')):
            cat = 'convolution / matmul'
        elif 'multi_tensor' in low or 'adam' in low:
            cat = 'optimizer'
        elif 'reduce' in low:
            cat = 'reductions (BatchNorm statistics, losses)'
        else:
            cat = 'elementwise and copies'
        cats[cat] = cats.get(cat, 0.0) + ms
    busy = sum(cats.values())
    log(f'[train profile] {tag}, one step (forward + backward + Adam, '
        f'profiler on): wall {wall_ms:.2f} ms, device busy {busy:.2f} ms, '
        f'idle share {1 - busy / wall_ms:.3f} | {card_line()}')
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        log(f'[train profile]   {cat}: {ms:.2f} ms ({ms / busy:.1%} of busy)')
    for name, ms, n in sorted(kernels, key=lambda r: -r[1])[:12]:
        log(f'[train profile]   {ms:8.3f} ms  x{n:<5d} {name[:90]}')
    del model, step
    torch.cuda.empty_cache()


def phase_train_handoff(dev, path, model_cfg, skeleton, records):
    """The trained checkpoint served: loaded into a serving PoseNet,
    BatchNorm folded, one 640^2 batch decoded through the fused peaks and
    grouping kernels (its launch counts, zeroed just before), and the
    kernels held against their plain versions on the trained model's maps
    and end to end."""
    import torch
    from offsetguided_tpu_torch.cli.serve import build_infer, cli

    sd = torch.load(path, map_location='cpu', weights_only=False)['model']
    infer, _, _, model = build_infer(cli([]), model_cfg, state_dict=sd,
                                     device=dev)
    images = torch.from_numpy(np.random.RandomState(11).randint(
        0, 256, (N_IMG, LONG_EDGE, LONG_EDGE, 3), dtype=np.uint8)).to(dev)
    reset_launches()
    poses, scores, counts = infer(images)
    torch.cuda.synchronize()
    launches = read_launches()
    check_launches('train_handoff', launches, ('peaks', 'grouping'),
                   never=('topk', 'nms_topk'))
    with plain_kernels():
        rp, rs, rc = infer(images)
    # one summation order for the pose score on both sides: the decodes
    # are equal place by place, bit for bit
    if not (torch.equal(counts, rc) and torch.equal(bits(poses), bits(rp))
            and torch.equal(bits(scores), bits(rs))):
        fail(f'train hand-off: kernel and plain decodes differ: counts '
             f'{counts.tolist()} vs {rc.tolist()}, poses by '
             f'{float((poses - rp).abs().max())}, scores by '
             f'{float((scores - rs).abs().max())}')

    hold_kernels('[train hand-off]', infer.postprocessor, model, images,
                 skeleton, J, records)
    log(f'[train hand-off] trained checkpoint served at {LONG_EDGE}^2 batch '
        f'{N_IMG}: counts {counts.tolist()}, kernel launches {launches}; '
        f'decode bit-equal to the plain kernels\' end to end, place by '
        f'place; peaks bit-equal on the trained maps')
    return launches


def hold_kernels(tag, pp, model, images, skeleton, n_keypoints, records):
    """The peaks and grouping kernels against their plain versions on the
    maps and limbs `model` gives `images`: peaks bit-equal, grouping
    bit-equal place by place (its error goes into `records`)."""
    import torch
    from offsetguided_tpu_torch.ops.cuda import peaks
    from offsetguided_tpu_torch.ops.image import normalize_images
    with torch.inference_mode():
        preds = model(normalize_images(images))
        hmp = pp.select_stage(preds)['hmp']
        n, h, w, c = hmp.shape
        maps = hmp.permute(0, 3, 1, 2).reshape(n * c, h, w).contiguous()
        packed = pp.decode_packed_limbs(preds).contiguous()
    v, ys, xs = peaks.peaks_topk(maps, TOPK)
    pv, pys, pxs = peaks.peaks_topk_plain(maps, TOPK)
    if not (torch.equal(ys, pys) and torch.equal(xs, pxs)
            and torch.equal(bits(v), bits(pv))):
        fail(f'{tag}: peaks kernel differs from plain')
    err = compare_grouping(f'{tag} grouping', packed, skeleton,
                           dataclasses.replace(pp.cfg,
                                               max_poses=pp.cfg.capacity),
                           n_keypoints=n_keypoints, exact=True)
    r = records['grouping']
    r['max_abs_err'] = max(r['max_abs_err'], err)


LOADER_WORKERS = 4            # the [train host] run's loader processes
BENCH_WORKERS = (0, 1, 4, 8)  # the loader's ms a batch, through bench_data
VAL_IMAGES = 16
SELFCHECK_BAR = 0.7           # AP, with AP50 = AP75 = 1.0 (cli/selfcheck.py)


def train_summary(tag, hist, wall, peak, ckpt, steps=TRAIN_STEPS,
                  net='Hourglass-104', falling=True):
    """Checks a full-width run's records (finite losses, no skipped step,
    where `falling` a falling heatmap loss, a checkpoint) and prints its
    img/s over steps 3-`steps` and at the median step, the step split and
    the host wait."""
    if len(hist) != steps:
        fail(f'{tag}: {len(hist)} step records, not {steps}')
    bad = [h['step'] for h in hist
           if not all(np.isfinite(h[k]) for k in ('total', 'hmp', 'bg',
                                                  'jomp', 'omp', 'scmp'))]
    if bad:
        fail(f'{tag}: non-finite losses at steps {bad}')
    if any(h['skipped'] != 0.0 for h in hist):
        fail(f'{tag}: skipped steps '
             f'{[h["step"] for h in hist if h["skipped"]]}')
    if falling and not hist[-1]['hmp'] < hist[0]['hmp']:
        fail(f'{tag}: heatmap loss did not fall: step 1 {hist[0]["hmp"]}, '
             f'step {steps} {hist[-1]["hmp"]}')
    if not (ckpt and os.path.isfile(ckpt)):
        fail(f'{tag}: no checkpoint ({ckpt})')
    timed = hist[2:]                 # steps 3..steps
    rate = TRAIN_BATCH * len(timed) / (timed[-1]['t'] - hist[1]['t'])
    gaps = sorted(b['t'] - a['t'] for a, b in zip(hist[1:], hist[2:]))
    med = gaps[len(gaps) // 2]
    mean = lambda k: sum(h[k] for h in timed) / len(timed)
    log(f'[{tag}] {net} {TRAIN_SIZE}^2 batch {TRAIN_BATCH}, '
        f'{steps} steps: {rate:.2f} img/s (host clock over steps '
        f'3-{steps}, with the epoch-end work after each 4th step); '
        f'{TRAIN_BATCH / med:.2f} img/s at the median step ({med * 1e3:.1f} '
        f'ms); per step feed {mean("feed_ms"):.2f} ms, forward + backward + '
        f'optimizer {mean("step_ms"):.2f} ms (CUDA events), host wait '
        f'{mean("host_wait_s") * 1e3:.2f} ms; peak memory {peak:.2f} GiB; '
        f'heatmap loss {hist[0]["hmp"]:.4f} -> {hist[-1]["hmp"]:.4f}; '
        f'{wall:.1f} s in all; checkpoint {os.path.basename(ckpt)} | '
        f'{card_line()}')


def phase_train_host(dev, root):
    """`cli.train.main` at full width on the host augmentation route (the
    JAX CLI's default): the 64-image hard set, 512^2, batch 16, Adam, 12
    steps, 4 loader processes, and the validation pass over 16 .npy
    hard-set images at each epoch end. Checks finite, falling losses, no
    skipped step, finite validation losses and a checkpoint; prints img/s,
    the step split, host wait, peak memory, and the loader's ms a batch by
    worker count (`cli.bench_data`), against the device-aug loader."""
    import torch
    from offsetguided_tpu_torch.cli import bench_data, train
    from offsetguided_tpu_torch.data.synthetic import make_hard_dataset

    img_dir, ann = make_hard_dataset(os.path.join(root, 'train'),
                                     n_images=TRAIN_IMAGES, seed=0, ext='npy')
    val_dir, val_ann = make_hard_dataset(os.path.join(root, 'val'),
                                         n_images=VAL_IMAGES, seed=1,
                                         ext='npy')
    argv = ['--train-image-dir', img_dir, '--train-annotations', ann,
            '--val-image-dir', val_dir, '--val-annotations', val_ann,
            '--batch-size', str(TRAIN_BATCH), '--square-length',
            str(TRAIN_SIZE), '--max-steps', str(TRAIN_STEPS),
            '--loader-workers', str(LOADER_WORKERS), '--print-freq', '1',
            '--checkpoint-dir', os.path.join(root, 'checkpoints_host')]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    r = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if any(read_launches().values()):
        fail(f'training launched a decode kernel: {read_launches()}')
    for h in r['history']:
        log(f'[train host] step {h["step"]}: total {h["total"]:.4f} hmp '
            f'{h["hmp"]:.4f} skipped {h["skipped"]:.0f}, host wait '
            f'{h["host_wait_s"]:.4f} s, feed {h["feed_ms"]:.2f} ms, forward'
            f'+backward+optimizer {h["step_ms"]:.2f} ms (CUDA events)')
    for v in r['val']:
        log(f'[train host] validation after epoch {v["epoch"]}: loss '
            f'{v["loss"]:.4f} over {v["batches"]} batch(es) of '
            f'{VAL_IMAGES} unaugmented images')
    if not r['val'] or not all(np.isfinite(v['loss']) for v in r['val']):
        fail(f'train host: validation losses {r["val"]}')
    train_summary('train host', r['history'], wall, peak, r['checkpoint'])
    torch.cuda.empty_cache()

    base = ['--image-dir', img_dir, '--annotation-file', ann,
            '--square-length', str(TRAIN_SIZE), '--batch-size',
            str(TRAIN_BATCH), '--n-batches', '8']
    runs = [(['--num-workers', str(n)], f'host route, {n} workers')
            for n in BENCH_WORKERS]
    runs.append((['--device-aug'], 'device-aug host path, 1 thread'))
    for extra, what in runs:
        rec = bench_data.main(base + extra)
        log(f'[train host] loader ({what}): {rec["loader_ms"]:.1f} ms a '
            f'batch of {TRAIN_BATCH} waited, {rec["interval_ms"]:.1f} ms a '
            f'batch pipelined ({rec["samples_per_s"]:.1f} samples/s), feed '
            f'{rec["feed_ms"]:.2f} ms (CUDA events), first batch '
            f'{rec["first_batch_s"]:.2f} s')


def phase_selfcheck(dev, root):
    """The port's self-check on the card, seed 0 and the JAX defaults, on
    the host route and then on the device-aug route: AP >= 0.7 and AP50 =
    AP75 = 1.0 on each; the evaluation's launches are each route's path
    (both must launch the fused peaks and grouping kernels). Then the
    host-route model served through `run_images` with the kernels and with
    their plain versions: identical record sets.
    Returns {'selfcheck_host': launches, 'selfcheck_device_aug': ...}."""
    import torch
    from offsetguided_tpu_torch.cli import selfcheck
    from offsetguided_tpu_torch.data.coco import CocoJson
    from offsetguided_tpu_torch.device import exact_fp32
    from offsetguided_tpu_torch.eval.harness import run_images

    launches, host = {}, None
    for route in ('host', 'device_aug'):
        path = f'selfcheck_{route}'
        argv = ['--seed', '0', '--min-ap', str(SELFCHECK_BAR),
                '--work-dir', os.path.join(root, path)]
        reset_launches()
        r = selfcheck.main(argv + (['--device-aug']
                                   if route == 'device_aug' else []))
        torch.cuda.synchronize()
        launches[path] = read_launches()
        st = r['stats']
        log(f'[selfcheck] {route} route: {r["steps"]} steps in '
            f'{r["train_s"]:.1f} s (training loop, host clock), AP '
            f'{st["AP"]:.4f}, AP50 {st["AP50"]:.4f}, AP75 {st["AP75"]:.4f}, '
            f'AR {st["AR"]:.4f}; losses {r["history"]}; kernel launches '
            f'{launches[path]} | {card_line()}')
        check_launches(path, launches[path], ('peaks', 'grouping'),
                       never=('topk', 'nms_topk'))
        if not (st['AP'] >= SELFCHECK_BAR and st['AP50'] == 1.0
                and st['AP75'] == 1.0):
            fail(f'selfcheck ({route}): AP {st["AP"]:.4f}, AP50 '
                 f'{st["AP50"]:.4f}, AP75 {st["AP75"]:.4f}; the bar is '
                 f'AP >= {SELFCHECK_BAR} with AP50 = AP75 = 1.0')
        if route == 'host':
            host = r

    coco = CocoJson(host['annotations'])
    args = (host['model'], host['postprocessor'], coco, host['image_dir'],
            host['eval_cfg'])
    with exact_fp32():
        ours = run_images(*args)
        with plain_kernels():
            ref = run_images(*args)

    def recs(results):
        return sorted((r['image_id'], tuple(np.round(r['keypoints'], 2)),
                       round(r['score'], 4)) for r in results)
    if recs(ours) != recs(ref):
        fail('selfcheck: the kernels\' records differ from the plain '
             'versions\' on the trained model')
    log(f'[selfcheck] host-route model served through run_images: kernel '
        f'and plain records identical ({len(ours)} records)')
    return launches


def tiny_train_batch():
    """Seeded uint8 images, annotations and mask of the one-step check."""
    rng = np.random.RandomState(2)
    size, n = 64, 2
    anns = np.zeros((n, 4, J, 4), np.float32)
    anns[:, :2, :, :2] = rng.rand(n, 2, J, 2) * size
    anns[:, :2, :, 2] = 2.0
    anns[:, :2, :, 3] = 5.0
    images = (rng.rand(n, size, size, 3) * 255).astype(np.uint8)
    mask = np.ones((n, size // 4, size // 4, 1), bool)
    mask[0, :3] = False
    return images, anns, mask


def tiny_feed(where):
    """The one-step check's batch on `where`: targets encoded there."""
    import torch
    from offsetguided_tpu_torch.config.defaults import (EncoderConfig,
                                                        SkeletonConfig)
    from offsetguided_tpu_torch.ops.encoder import encode_targets
    sk = SkeletonConfig()
    images, anns, mask = tiny_train_batch()
    t = encode_targets(torch.from_numpy(anns).to(where), sk.sigmas,
                       sk.skeleton, 16, 16, EncoderConfig(max_persons=4))
    return (torch.from_numpy(images).to(where), t,
            torch.from_numpy(mask).to(where))


def host_route_feed(root):
    """A host-route batch of two 128^2 samples (the port's host warp at
    scale 0.2-0.3, so the whole scene is in view, flipped, rotated, grayed
    and tinted by chance) from 2 .npy hard-set images, as a function of
    the device it is fed to (`cli/train.py::device_batch`: H2D, GT
    encoding and mask downscaling there)."""
    from offsetguided_tpu_torch.cli.train import device_batch
    from offsetguided_tpu_torch.config.defaults import (
        AugmentationConfig, EncoderConfig, SkeletonConfig)
    from offsetguided_tpu_torch.data import pipeline
    from offsetguided_tpu_torch.data.synthetic import make_hard_dataset
    img_dir, ann = make_hard_dataset(os.path.join(root, 'one_step'),
                                     n_images=2, seed=4, ext='npy')
    ds = pipeline.CocoKeypoints(
        img_dir, ann, aug=AugmentationConfig(
            square_length=128, min_scale=0.2, max_scale=0.3,
            max_translate=10, gray_prob=0.5, color_tint_prob=0.5),
        square_length=128, max_persons=8)
    batch = pipeline._make_batch(ds, [0, 1], pipeline._batch_rng(0, 0, 0), 0)

    def feed(where):
        import torch
        return device_batch(batch, ds, torch.device(where),
                            EncoderConfig(max_persons=8), SkeletonConfig(),
                            128)
    return feed


def train_one_step_errors(dev, feed, dtype: str = 'float32',
                          model_kw=TINY_TRAIN):
    """One SGD step (TF32 off) of the model of `model_kw` (default the
    tiny one) in `dtype` on the card and on the CPU, from the same
    weights, on `feed(device)`'s batch: the largest relative loss error,
    gradient error (|diff| - 1e-3 |g|, over the largest gradient),
    BatchNorm statistics error, and the skipped flags."""
    import torch
    from offsetguided_tpu_torch.config.defaults import (LossConfig,
                                                        ModelConfig,
                                                        TrainConfig)
    from offsetguided_tpu_torch.device import exact_fp32
    from offsetguided_tpu_torch.models import PoseNet
    from offsetguided_tpu_torch.models.network import init_reference_
    from offsetguided_tpu_torch.parallel.train_step import (TrainStep,
                                                            make_optimizer)

    cfg = ModelConfig(**dict(model_kw, compute_dtype=dtype))
    init = init_reference_(PoseNet(cfg), torch.Generator().manual_seed(0))
    lr = 1e-3
    out = {}
    with exact_fp32():
        for where in ('cpu', dev):
            net = PoseNet(cfg)
            net.load_state_dict(init.state_dict())
            net = net.to(where, getattr(torch, dtype))
            step = TrainStep(net, make_optimizer(
                TrainConfig(optimizer='sgd', learning_rate=lr),
                net.parameters()), LossConfig(stack_weights=(1.0,)))
            images, targets, mask = feed(where)
            targets = type(targets)(*[t.to(getattr(torch, dtype))
                                      for t in targets])
            m = step(images, targets, mask)
            out[str(where)] = ({k: float(v) for k, v in m.items()},
                               {k: v.detach().cpu().double()
                                for k, v in net.state_dict().items()})
    (mc, sc), (mg, sg) = out['cpu'], out[str(dev)]
    loss_err = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in mc)
    p0 = {k: v.double() for k, v in init.state_dict().items()}
    grads = {k: ((p0[k] - sc[k]) / lr, (p0[k] - sg[k]) / lr) for k in sc
             if 'running' not in k and 'num_batches' not in k}
    gmax = max(float(a.abs().max()) for a, _ in grads.values())
    g_err = max(float(((b - a).abs() - 1e-3 * a.abs()).max())
                for a, b in grads.values()) / gmax
    bn_err = max(float((sg[k] - sc[k]).abs().max()) for k in sc
                 if 'running' in k)
    return dict(loss=loss_err, grad=g_err, grad_max=gmax, bn=bn_err,
                skipped=(mc['skipped'], mg['skipped']))


def one_step_ok(e) -> bool:
    """The CPU tests' tolerances: losses 1e-4 relative, gradients 1e-3
    relative + 1e-4 of the largest, BatchNorm statistics 1e-5."""
    return (e['loss'] <= 1e-4 and e['grad'] <= 1e-4 and e['bn'] <= 1e-5
            and e['skipped'] == (0.0, 0.0))


def host_route_targets_error(dev, feed) -> float:
    """The largest difference between the host-route batch's targets
    encoded on the card and on the CPU (inf where their +inf / NaN
    sentinels fall differently)."""
    import torch
    _, tc, mc = feed('cpu')
    _, tg, mg = feed(dev)
    err = 0.0 if torch.equal(mc, mg.cpu()) else float('inf')
    for x, y in zip(tc, tg):
        y = y.cpu()
        fin = torch.isfinite(x)
        if not torch.equal(fin, torch.isfinite(y)):
            return float('inf')
        d = (x - y).abs()[fin]
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def phase_train_one_step(dev, root):
    """The one-step check, card vs CPU: an fp32 step on the tiny seeded
    batch; on a host-route batch (warped, grayed and tinted on the host,
    encoded on each device) the targets within 1e-6 and an fp64 step. (In
    fp32 that batch meets a near-tie of rounding on the card: one deep
    conv's gradient moves by 0.75 % of the largest while the card's and
    the CPU's fp64 steps agree to 7e-8; ROADMAP Queue 3.)"""
    feed = host_route_feed(root)
    t_err = host_route_targets_error(dev, feed)
    log(f'[train one-step] host-route batch: targets encoded on the card '
        f'vs the CPU, max abs err {t_err:.3g}')
    if not t_err <= 1e-6:
        fail('train one-step: host-route targets differ card vs CPU')
    for what, fd, dtype in (('tiny batch', tiny_feed, 'float32'),
                            ('host-route batch', feed, 'float64')):
        e = train_one_step_errors(dev, fd, dtype)
        log(f'[train one-step] {what}: {dtype} SGD step of the tiny model, '
            f'card vs CPU: losses max rel err {e["loss"]:.3g}, gradients max '
            f'(|diff| - 1e-3 |g|) {e["grad"]:.3g} of the largest gradient '
            f'{e["grad_max"]:.3g}, BN statistics max abs err {e["bn"]:.3g}')
        if not one_step_ok(e):
            fail(f'train one-step ({what}): card and CPU differ past the '
                 f'CPU tests\' tolerances')


# [ddp]: cli/train.py --distributed at world size 1 over NCCL, in turns
# with the one-process run, and two gloo ranks sharing the card
DDP_STEPS, DDP_TURNS, DDP_GLOO_STEPS = 8, 2, 4


def ddp_argv(img_dir, ann, ckpt_dir, steps):
    """The [train] configuration (device-aug route, 512^2, global batch
    16), `steps` steps, no epoch-end checkpoint (the last step writes
    one)."""
    return ['--device-aug', '--train-image-dir', img_dir,
            '--train-annotations', ann, '--batch-size', str(TRAIN_BATCH),
            '--square-length', str(TRAIN_SIZE), '--max-steps', str(steps),
            '--print-freq', '1', '--save-every', '1000',
            '--checkpoint-dir', ckpt_dir]


def ddp_history_ok(tag, hist, steps):
    """Finite losses and no skipped step over `steps` records; returns
    img/s over steps 3-`steps` (host clock) and the median step (ms)."""
    if len(hist) != steps:
        fail(f'{tag}: {len(hist)} step records, not {steps}')
    if not all(np.isfinite(h[k]) for h in hist
               for k in ('total', 'hmp', 'omp', 'scmp')):
        fail(f'{tag}: non-finite losses')
    if any(h['skipped'] for h in hist):
        fail(f'{tag}: skipped steps')
    rate = TRAIN_BATCH * (steps - 2) / (hist[-1]['t'] - hist[1]['t'])
    gaps = sorted(b['t'] - a['t'] for a, b in zip(hist[1:], hist[2:]))
    return rate, gaps[len(gaps) // 2] * 1e3


def phase_ddp(dev, root):
    """`cli.train --distributed` on the card at the [train] configuration
    (full-width Hourglass-104, 512^2, global batch 16, device-aug route):
    world size 1 over NCCL and the one-process run in turns, 8 steps each,
    img/s and peak memory side by side (the cost of the process group,
    the synchronized BatchNorm's collectives and DDP); then two gloo ranks
    sharing the card (`--share-device`, 8 images a rank), 4 steps: finite
    global losses, no skipped step, the ranks' weights bit-equal (SHA-256
    of each rank's state dict), rank 0 alone writing the checkpoint, and
    each rank's peak memory."""
    import shutil
    import torch
    from offsetguided_tpu_torch.cli import train
    from offsetguided_tpu_torch.data.synthetic import make_hard_dataset
    from offsetguided_tpu_torch.parallel import distributed, parity

    img_dir, ann = make_hard_dataset(os.path.join(root, 'ddp'),
                                     n_images=TRAIN_IMAGES, seed=0, ext='npy')
    world1 = ['--distributed', '--num-processes', '1', '--process-id', '0']
    runs = {'one process': [], 'ddp world 1 (NCCL)': []}
    for turn in range(DDP_TURNS):
        for tag, out in runs.items():
            ck = os.path.join(root, 'ddp_ck')
            extra = [] if tag == 'one process' else world1 + [
                '--coordinator-address',
                f'localhost:{distributed.free_port()}']
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            r = train.main(ddp_argv(img_dir, ann, ck, DDP_STEPS) + extra)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if distributed.active():
                fail('[ddp] the process group outlived cli.train.main')
            rate, med = ddp_history_ok(f'[ddp] {tag}', r['history'],
                                       DDP_STEPS)
            out.append((rate, med, peak))
            log(f'[ddp] turn {turn + 1}, {tag}: {rate:.2f} img/s (host '
                f'clock over steps 3-{DDP_STEPS}), median step {med:.1f} ms, '
                f'peak memory {peak:.2f} GiB | {card_line()}')
            shutil.rmtree(ck, ignore_errors=True)
            del r
    (a, b) = (np.mean([x[0] for x in v]) for v in runs.values())
    log(f'[ddp] world size 1 against one process, {DDP_TURNS} turns each: '
        f'{b:.2f} / {a:.2f} img/s (ratio {b / a:.3f}) | {card_line()}')

    ck = os.path.join(root, 'ddp_gloo')
    argv = ['--device', 'cuda', '--share-device'] + ddp_argv(
        img_dir, ann, ck, DDP_GLOO_STEPS)
    torch.cuda.empty_cache()
    ranks = [r[0] for r in distributed.spawn(
        parity.train_cli, 2, [(argv, distributed.free_port())], 4, False,
        timeout=900)]
    for r in ranks:
        ddp_history_ok(f'[ddp] gloo rank {r["rank"]}', r['history'],
                       DDP_GLOO_STEPS)
    r0, r1 = ranks
    if r0['digest'] != r1['digest']:
        fail('[ddp] gloo ranks end with different weights')
    if r1['checkpoint'] is not None or sorted(os.listdir(ck)) != [
            os.path.basename(r0['checkpoint'])]:
        fail(f'[ddp] checkpoints: rank 0 {r0["checkpoint"]}, rank 1 '
             f'{r1["checkpoint"]}, written {sorted(os.listdir(ck))}')
    if [h['total'] for h in r0['history']] != [h['total'] for h in
                                               r1['history']]:
        fail('[ddp] gloo ranks report different global losses')
    shutil.rmtree(ck, ignore_errors=True)
    rate = TRAIN_BATCH * (DDP_GLOO_STEPS - 2) / (
        r0['history'][-1]['t'] - r0['history'][1]['t'])
    log(f'[ddp] two gloo ranks sharing the card, {DDP_GLOO_STEPS} steps of '
        f'global batch {TRAIN_BATCH}: losses finite, no skipped step, global '
        f'total {r0["history"][0]["total"]:.4f} -> '
        f'{r0["history"][-1]["total"]:.4f} on both ranks, weights bit-equal '
        f'(sha256 {r0["digest"][:16]}), rank 0 alone wrote the checkpoint; '
        f'{rate:.2f} img/s over steps 3-{DDP_GLOO_STEPS}; peak memory rank 0 '
        f'{r0["peak_gib"]:.2f} GiB, rank 1 {r1["peak_gib"]:.2f} GiB | '
        f'{card_line()}')


def phase_ddp_one_step(dev):
    """The one-step check's tiny model and batch (`tiny_train_batch`), TF32
    off: one SGD step in this process on the card, on the whole batch,
    against two gloo ranks sharing the card, one image each, at the CPU
    tests' tolerances (`one_step_ok`). fp32 is held first; where it meets
    a near-tie of rounding the fp64 step must pass (as `[train one-step]`
    holds its host-route batch)."""
    import torch
    from offsetguided_tpu_torch.config.defaults import ModelConfig
    from offsetguided_tpu_torch.models import PoseNet
    from offsetguided_tpu_torch.models.network import init_reference_
    from offsetguided_tpu_torch.parallel import distributed, parity

    images, anns, mask = tiny_train_batch()
    init = init_reference_(PoseNet(ModelConfig(**TINY_TRAIN)),
                           torch.Generator().manual_seed(0))
    state = {k: v.numpy() for k, v in init.state_dict().items()}
    kw = dict(model_kw=TINY_TRAIN, state=state, images=images, anns=anns,
              mask=mask)
    for dtype in ('float32', 'float64'):
        ranks = distributed.spawn(parity.run_cases, 2, [
            ('step', 'train_step', dict(kw, dtype=dtype))], 'cuda', True, 2)
        if ranks[0]['step']['digest'] != ranks[1]['step']['digest']:
            fail(f'[ddp one-step] {dtype}: the ranks end with different '
                 f'weights')
        e = parity.step_errors(
            state, parity.train_step(dev, **kw, dtype=dtype),
            ranks[0]['step'])
        ok = one_step_ok(e)
        log(f'[ddp one-step] {dtype} SGD step of the tiny model, one card '
            f'process vs two gloo ranks on the card (1 + 1 images): losses '
            f'max rel err {e["loss"]:.3g}, gradients max (|diff| - 1e-3 |g|) '
            f'{e["grad"]:.3g} of the largest gradient {e["grad_max"]:.3g}, '
            f'BN statistics max abs err {e["bn"]:.3g}: '
            f'{"within" if ok else "past"} the one-step tolerances')
        if ok:
            return
    fail('[ddp one-step]: one card process and two ranks differ past the '
         'one-step tolerances in fp32 and in fp64')


def phase_dryrun():
    """`parallel/dryrun.py::dryrun_multichip(2)` with both gloo ranks on
    the card: one data-parallel step of the dry run's narrow Hourglass-104,
    each rank's forward + decode and device augmentation, the shapes and
    finiteness `_dryrun_impl` asserts, and the ranks' weights bit-equal."""
    from offsetguided_tpu_torch.parallel.dryrun import dryrun_multichip
    t0 = time.perf_counter()
    out = dryrun_multichip(2)             # the default: the card
    log(f'[dryrun] 2 gloo ranks on the card: loss {out[0]["loss"]:.6g}, '
        f'poses {out[0]["poses_shape"]} a rank, warped images '
        f'{out[0]["aug_shape"]} a rank, weights bit-equal (sha256 '
        f'{out[0]["checksum"][:16]}); {time.perf_counter() - t0:.1f} s')


def phase_codec():
    """The port's JPEG / PNG codec, built on this host: the pinned bodies
    decode to the pinned pixels (CODEC_DIGESTS, PROGRESSIVE_DIGESTS,
    JPEG_FILE_DIGESTS: cv2.imdecode's where a CPU test pinned them), the
    480x640 body's arithmetic twin to its pixels, and the decode time of
    the 480x640 body (Huffman, arithmetic, progressive) and of painted
    hard-set scenes on one host thread."""
    from offsetguided_tpu_torch.cli.bench_serve import make_test_jpegs
    from offsetguided_tpu_torch.data import codec

    for name, body in codec_cases():
        px = codec.decode(body)
        got, want = codec_digests(body, px), CODEC_DIGESTS[name]
        if got[1] != want[1] or (want[0] is not None and got[0] != want[0]):
            fail(f'[codec] {name}: digests {got}, pinned {want}')
    log(f'[codec] {len(CODEC_CASES)} bodies (JPEG 4:4:4, 4:2:2, 4:2:0, '
        f'4:4:0, 4:1:1, restarts, grey; PNG RGB, grey): bodies and pixels '
        f'equal to the pinned digests')
    for name, body in progressive_cases():
        got = codec_digests(body, codec.decode(body))
        if got != PROGRESSIVE_DIGESTS[name][1:]:
            fail(f'[codec] {name}: digests {got}, pinned '
                 f'{PROGRESSIVE_DIGESTS[name][1:]}')
    log(f'[codec] {len(PROGRESSIVE_DIGESTS)} progressive bodies (cv2-written:'
        f' 4:2:0, 4:4:4, grey, restarts): pixels equal to cv2.imdecode\'s '
        f'pinned digests')
    for name, body in progressive_cases(JPEG_FILE_DIGESTS):
        got = codec_digests(body, codec.decode(body))
        if got != JPEG_FILE_DIGESTS[name][1:]:
            fail(f'[codec] {name}: digests {got}, pinned '
                 f'{JPEG_FILE_DIGESTS[name][1:]}')
    log(f'[codec] {len(JPEG_FILE_DIGESTS)} bodies of the other processes '
        f'({", ".join(JPEG_FILE_DIGESTS)}): bodies and pixels equal to the '
        f'pinned digests (cv2.imdecode\'s pixels)')
    bodies = dict(codec_cases())
    t0 = time.perf_counter()
    arith = arithmetic_twin(bodies['jpeg 420 q95'])
    t_twin = time.perf_counter() - t0
    got = codec_digests(arith, codec.decode(arith))
    want = (ARITH_480_DIGEST, CODEC_DIGESTS['jpeg 420 q95'][1])
    if got != want:
        fail(f'[codec] 480x640 arithmetic twin: digests {got}, pinned {want}')
    log(f'[codec] the 480x640 4:2:0 q95 body transcoded to arithmetic coding '
        f'on this host ({t_twin:.1f} s in Python): body digest pinned, pixels '
        f'equal to its Huffman twin\'s')
    log(f'[codec] card: {card_line()}')
    timed = [('480x640 q95 4:2:0 noisy gradient', bodies['jpeg 420 q95']),
             ('480x640 q95 4:2:0 noisy gradient, arithmetic', arith),
             ('480x640 q95 4:2:0 noisy gradient, progressive',
              dict(progressive_cases())['progressive 420 q95'])]
    timed += [(f'{codec.decode(b).shape[1]}x{codec.decode(b).shape[0]} '
               f'painted hard-set scene', b) for b in make_test_jpegs(2)]
    for what, body in timed:
        ts = []
        for _ in range(30):
            t0 = time.perf_counter()
            codec.decode(body)
            ts.append(time.perf_counter() - t0)
        img = codec.decode(body)
        t0 = time.perf_counter()
        for _ in range(5):
            codec.encode_jpeg(img)
        enc = (time.perf_counter() - t0) / 5
        log(f'[codec] decode {what} ({len(body)} bytes): median '
            f'{np.median(ts) * 1e3:.2f} ms, min {min(ts) * 1e3:.2f} ms on one '
            f'host thread; encode q95 {enc * 1e3:.2f} ms')


SERVE_REQUESTS = 48


def phase_serve_http(dev):
    """`cli.serve`'s HTTP server at full width (batch 8, 640^2, flip off)
    on port 0 in a thread, upsampled and `--lowres-decode`: 48 concurrent
    POSTs of codec JPEGs of the hard set's mixed sizes; every answer 200
    with poses of 17 keypoints; each mode's kernels launched. The
    upsampled server then answers the committed progressive 480x640 body,
    its arithmetic twin and the committed Pillow CMYK body 200, each with
    the poses it gives the PNG of the same pixels."""
    from offsetguided_tpu_torch.cli.bench_serve import make_test_jpegs

    bodies = make_test_jpegs(SERVE_REQUESTS, seed=1)
    modes = {'serve_http': ([], ('peaks', 'grouping'), ('topk', 'nms_topk')),
             'serve_http_lowres': (['--lowres-decode'],
                                   ('nms_topk', 'grouping'),
                                   ('peaks', 'topk'))}
    twins = [('progressive 480x640',
              dict(progressive_cases())['progressive 420 q95']),
             ('arithmetic 480x640',
              arithmetic_twin(dict(codec_cases())['jpeg 420 q95'])),
             ('Pillow CMYK 64x96',
              dict(progressive_cases(JPEG_FILE_DIGESTS))['Pillow CMYK 420'])]
    return {path: serve_burst(dev, path, extra, need, never, bodies, J,
                              twins if path == 'serve_http' else ())
            for path, (extra, need, never) in modes.items()}


def post_json(url, body, timeout=300):
    """(status, JSON answer) of one POST /v1/poses."""
    import urllib.request
    req = urllib.request.Request(url + '/v1/poses', data=body)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def serve_burst(dev, path, extra, need, never, bodies, n_kp,
                twins=()) -> dict:
    """One full-width `cli.serve` server (its flags plus `extra`) on port 0
    in a thread, `bodies` POSTed at once: every answer 200 with poses of
    `n_kp` keypoints, the kernels of `need` launched and none of `never`.
    Then for each (name, JPEG body) of `twins`, that body and the PNG of its
    pixels are POSTed one after the other: both 200, the same poses.
    Returns the path's launches."""
    import torch
    import urllib.request
    from offsetguided_tpu_torch.cli import serve
    from offsetguided_tpu_torch.cli.bench_serve import percentiles

    args = serve.cli(['--port', '0', '--request-timeout-s', '120'] + extra)
    infer, skeleton, ecfg, _ = serve.build_infer(args, device=dev)
    s = ecfg.long_edge
    infer(torch.zeros((ecfg.batch_size, s, s, 3), dtype=torch.uint8,
                      device=dev))[2].cpu()
    srv = serve.make_server(args, infer, skeleton, ecfg)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = 'http://%s:%d' % srv.server_address[:2]
    answers, lats = [None] * len(bodies), [None] * len(bodies)

    def post(i):
        req = urllib.request.Request(url + '/v1/poses', data=bodies[i],
                                     headers={'Content-Type': 'image/jpeg'})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                answers[i] = (r.status, json.loads(r.read()))
        except Exception as e:  # reported below; the phase then fails
            answers[i] = (None, repr(e))
        lats[i] = time.perf_counter() - t0

    reset_launches()
    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(bodies))]
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = read_launches()
        with urllib.request.urlopen(url + '/metrics', timeout=30) as r:
            m = json.loads(r.read())
        answered = []
        for name, body in twins:
            from offsetguided_tpu_torch.data import codec
            png = codec.encode_png(codec.decode(body))
            answered.append((name, [post_json(url, b) for b in (body, png)]))
    finally:
        srv.shutdown()
        srv.server_close()
    for name, twin in answered:
        for _, a in twin:
            a.pop('latency_ms', None)
        if [st for st, _ in twin] != [200, 200] or twin[0][1] != twin[1][1]:
            fail(f'{path}: the {name} JPEG and its PNG twin answered '
                 f'{[st for st, _ in twin]}, poses equal: '
                 f'{twin[0][1] == twin[1][1]}')
        log(f'[serve http] {path}: a {name} JPEG POSTed: 200, '
            f'{len(twin[0][1]["poses"])} poses, equal to its PNG twin\'s')
    bad = [a for a in answers if a is None or a[0] != 200]
    if bad:
        fail(f'{path}: {len(bad)} of {len(bodies)} requests failed: '
             f'{bad[:3]}')
    n_poses = [len(a[1]['poses']) for a in answers]
    if any(n == 0 for n in n_poses) or any(
            len(p['keypoints']) != n_kp for a in answers
            for p in a[1]['poses']):
        fail(f'{path}: an answer without poses of {n_kp} keypoints: '
             f'{n_poses}')
    check_launches(path, launches, need, never)
    pct = percentiles(lats)
    log(f'[serve http] {path}: {len(bodies)} concurrent POSTs of '
        f'{len(set(a[1]["image"]["width"] for a in answers))}-width '
        f'JPEGs all 200, poses of {n_kp} keypoints, '
        f'{min(n_poses)}-{max(n_poses)} an answer; '
        f'{len(bodies) / wall:.2f} QPS (host clock, one burst), client '
        f'p50 {pct["p50"]:.1f} / p90 {pct["p90"]:.1f} / p99 '
        f'{pct["p99"]:.1f} ms, mean batch fill {m["mean_batch_fill"]}, '
        f'device-batch p50 {m["device_batch_latency_ms"]["p50"]} ms over '
        f'{m["batches"]} batches, kernel launches {launches}')
    del infer, srv
    torch.cuda.empty_cache()
    return launches


def phase_bench():
    """`cli.bench`: full-width Hourglass-104 bf16 at 640^2, batch 8, flip
    off and on; its JSON line, and the peaks + grouping launches."""
    import torch
    from offsetguided_tpu_torch.cli import bench

    reset_launches()
    out = bench.main([])
    torch.cuda.synchronize()
    launches = read_launches()
    check_launches('bench', launches, ('peaks', 'grouping'),
                   never=('topk', 'nms_topk'))
    if not (out['value'] > 0 and out['flip_value'] > 0):
        fail(f'bench: {out}')
    log(f'[bench] {out["value"]} img/s flip off, {out["flip_value"]} img/s '
        f'flip on, batch {out["batch"]} (host clock between two '
        f'synchronizations), kernel launches {launches}')
    torch.cuda.empty_cache()
    return {'bench': launches}


BENCH_SERVE_ARGS = ['--concurrency', '16', '--duration', '15', '--json']


def phase_bench_serve():
    """`cli.bench_serve` in its subprocess mode: the port's server started
    as `python -m offsetguided_tpu_torch.cli.serve` (full width, batch 8),
    16 closed-loop clients posting JPEGs for 15 s; then `--in-process`
    (the batcher driven with preprocessed images: no HTTP, no decode) and
    the host work a request costs on one thread, which together say where
    the served time goes."""
    from offsetguided_tpu_torch.cli import bench_serve
    from offsetguided_tpu_torch.config.defaults import EvalConfig
    from offsetguided_tpu_torch.data import codec
    from offsetguided_tpu_torch.eval.harness import preprocess_eval

    out = bench_serve.main(BENCH_SERVE_ARGS)
    if 'error' in out or out['client_errors'] or out['server']['errors']:
        fail(f'bench_serve: {out}')
    lat, srv = out['latency_ms'], out['server']
    log(f'[bench_serve] cold start to /healthz {out["startup_s"]} s; '
        f'{out["qps"]} QPS at concurrency 16 over {out["duration_s"]} s '
        f'({out["requests"]} requests); client p50 {lat["p50"]} / p90 '
        f'{lat["p90"]} / p99 {lat["p99"]} ms; server mean batch fill '
        f'{srv["mean_batch_fill"]}, device-batch p50 / p99 '
        f'{srv["device_batch_latency_ms"]["p50"]} / '
        f'{srv["device_batch_latency_ms"]["p99"]} ms')
    inp = bench_serve.main(BENCH_SERVE_ARGS + ['--in-process'])
    if 'error' in inp or inp['client_errors'] or inp['batcher']['errors']:
        fail(f'bench_serve --in-process: {inp}')
    lat, b = inp['submit_latency_ms'], inp['batcher']
    log(f'[bench_serve] in process (no HTTP, images decoded and '
        f'preprocessed once): {inp["qps"]} QPS, submit p50 {lat["p50"]} / '
        f'p99 {lat["p99"]} ms, mean fill {b["mean_batch_fill"]}, '
        f'device-batch p50 {b["device_batch_latency_ms"]["p50"]} ms; one '
        f'resident batch {inp["device_floor_ms_per_batch"]} ms (CUDA '
        f'events), {inp["device_floor_qps_at_full_fill"]} QPS at full fill')
    cfg = EvalConfig(long_edge=LONG_EDGE, batch_size=N_IMG)
    dec, pre = [], []
    for body in bench_serve.make_test_jpegs(24):
        t0 = time.perf_counter()
        img = codec.decode(body)
        t1 = time.perf_counter()
        preprocess_eval(img, np.zeros((0, J, 4), np.float32), cfg)
        dec.append(t1 - t0)
        pre.append(time.perf_counter() - t1)
    log(f'[bench_serve] host work a request, one thread, the 24 bodies: '
        f'JPEG decode median {np.median(dec) * 1e3:.2f} ms, preprocess '
        f'(rescale + pad) median {np.median(pre) * 1e3:.2f} ms, max '
        f'{max(pre) * 1e3:.2f} ms')


def phase_bench_e2e(root):
    """`cli.bench_e2e` on the 100-image hard set written as codec JPEGs,
    4 IO workers: long edge 640 flip off and on (peaks + grouping), then
    fixed height (block top-k + grouping)."""
    import torch
    from offsetguided_tpu_torch.cli import bench_e2e

    base = ['--data-root', os.path.join(root, 'bench_e2e'), '--n-images',
            '100', '--io-workers', '4']
    runs = {'bench_e2e': (['--modes', 'noflip,flip'], ('peaks', 'grouping'),
                          ('topk', 'nms_topk')),
            'bench_e2e_fixed_height': (['--modes', 'noflip',
                                        '--fixed-height'],
                                       ('topk', 'grouping'),
                                       ('peaks', 'nms_topk'))}
    launches = {}
    for path, (extra, need, never) in runs.items():
        reset_launches()
        lines = bench_e2e.main(base + extra)
        torch.cuda.synchronize()
        launches[path] = read_launches()
        check_launches(path, launches[path], need, never)
        for x in lines:
            if not x['value'] > 0 or x['n_results'] < x['n_images']:
                fail(f'{path}: {x}')
            log(f'[bench_e2e] {x["metric"]}: {x["value"]} img/s from disk '
                f'(host clock; JPEG decode, preprocess, forward, decode, '
                f'records), cold pass {x["cold_pass_s"]} s, '
                f'{x["n_results"]} records'
                + (f', {x["n_padded_shapes"]} padded shapes'
                   if 'n_padded_shapes' in x else ''))
        log(f'[bench_e2e] {path}: kernel launches {launches[path]}')
        torch.cuda.empty_cache()
    return launches


def phase_tools_profile():
    """`cli.profile_forward` (top 10 device operations) and
    `cli.profile_decode --stages` at 640^2, batch 8."""
    import torch
    from offsetguided_tpu_torch.cli import profile_decode, profile_forward

    fwd = profile_forward.main([])
    if not fwd['top_ops']:
        log('[profile tools] the profiler recorded no device time: '
            'not measured')
    log(f'[profile tools] forward {fwd["ms_per_batch"]} ms a batch of '
        f'{fwd["batch"]} '
        f'(CUDA events), {fwd["tflop_per_s"]} TFLOP/s of '
        f'{fwd["tflop_per_batch"]} TFLOP counted')
    for op in fwd['top_ops']:
        log(f'[profile tools]   {op["ms"]:9.3f} ms x{op["calls"]:<5d} '
            f'{op["share"]:6.1%} {op["name"][:80]}')
    torch.cuda.empty_cache()
    reset_launches()
    dec = profile_decode.main(['--stages'])
    torch.cuda.synchronize()
    launches = read_launches()
    check_launches('profile_decode', launches, ('peaks', 'grouping'),
                   never=('topk', 'nms_topk'))
    log(f'[profile tools] decode {dec["decode_ms"]} ms a batch of '
        f'{dec["batch"]} (CUDA '
        f'events); stages (ms, card synchronized at each edge): '
        f'{dec["stages_ms"]}')
    torch.cuda.empty_cache()
    return {'profile_decode': launches}


# --------------------------------------------------------------------------- #
# the CrowdPose configuration and the 4-stage backbone
# --------------------------------------------------------------------------- #

CROWDPOSE_ORACLE_IMAGES = 99       # 33 a crowdIndex band
FOUR_STAGE_STEPS, CROWDPOSE_TRAIN_STEPS = 8, 4


def crowdpose_selection_maps(model, dev):
    """The CrowdPose model's (8 * 14, h, w) maps for the selection kernels:
    its square 640^2 heatmaps, and the 2x2 block maxima of its NMS'd x4
    heatmaps at 640x1024 (the fixed-height route's top-k input)."""
    import torch
    import torch.nn.functional as F
    from offsetguided_tpu_torch.ops import decoder as dec
    from offsetguided_tpu_torch.ops.image import normalize_images
    from offsetguided_tpu_torch.ops.resize import upsample2d
    square = torch.from_numpy(np.random.RandomState(21).randint(
        0, 256, (N_IMG, LONG_EDGE, LONG_EDGE, 3), dtype=np.uint8)).to(dev)
    wide = torch.from_numpy(fixed_height_images(N_IMG, 22)).to(dev)
    with torch.inference_mode():
        hmp = model(normalize_images(square))['hmp'][-1]
        n, h, w, c = hmp.shape
        maps = hmp.permute(0, 3, 1, 2).reshape(n * c, h, w).contiguous()
        hw = model(normalize_images(wide))['hmp'][-1]
        nmsed = dec.hmp_nms(upsample2d(hw, STRIDE, 'bicubic'))
        bm = F.max_pool2d(nmsed.permute(0, 3, 1, 2), 2, stride=2)
        bm = bm.reshape(bm.shape[0] * bm.shape[1], -1).contiguous()
    return maps, bm


def phase_crowdpose(dev, records):
    """CrowdPose at full width: Hourglass-104 with 14 / 17 heads
    (`random_posenet`, calibrated at 640^2) served through `build_infer`
    at batch 8, 640^2, flip off and on (each path with its own launch
    counts); peaks bit-equal to plain on the model's (112, 160, 160) maps,
    the general grouping build held against plain on the served limbs and
    on a J = 14 crowd at capacity 128, and timed (with, on the same limbs,
    the J = 17 build over the joints padded to 17); block top-k and NMS +
    top-k at M = 112 on the model's maps; the flip-on decode kernel vs
    plain end to end. Returns the paths' launches."""
    import torch
    from offsetguided_tpu_torch.cli.serve import build_infer, cli
    from offsetguided_tpu_torch.config.defaults import SkeletonConfig
    from offsetguided_tpu_torch.eval.harness import make_infer_fn
    from offsetguided_tpu_torch.ops import grouping as plain
    from offsetguided_tpu_torch.ops.cuda import grouping, nms_topk, peaks, topk
    from offsetguided_tpu_torch.ops.image import normalize_images

    sk = SkeletonConfig.crowdpose().skeleton
    infer, skeleton, _, model = build_infer(cli(['--dataset', 'crowdpose']),
                                            device=dev, seed=0)
    pp = infer.postprocessor
    images = torch.from_numpy(np.random.RandomState(17).randint(
        0, 256, (N_IMG, LONG_EDGE, LONG_EDGE, 3), dtype=np.uint8)).to(dev)
    infers = {False: infer, True: make_infer_fn(model, pp, True)}
    launches = {}
    for flip in (False, True):
        path = 'crowdpose_flip_on' if flip else 'crowdpose_flip_off'
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        for _ in range(2):
            infers[flip](images)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            poses, scores, counts = infers[flip](images)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[path] = read_launches()
        if tuple(poses.shape) != (N_IMG, 40, J14, 6):
            fail(f'{path}: poses shape {tuple(poses.shape)}')
        if not (torch.isfinite(poses).all() and torch.isfinite(scores).all()
                and int(counts.sum()) > 0):
            fail(f'{path}: non-finite poses or none')
        check_launches(path, launches[path], ('peaks', 'grouping'),
                       never=('topk', 'nms_topk'))
        log(f'[crowdpose] {path}: {N_IMG * 5 / dt:.2f} img/s (host clock, '
            f'batch {N_IMG}, {LONG_EDGE}^2, 14 keypoints, 17 limbs), counts '
            f'{counts.tolist()}, peak memory '
            f'{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB, '
            f'kernel launches {launches[path]} | {card_line()}')
        if flip:
            with plain_kernels():
                rp, rs, rc = infers[flip](images)
            if not (torch.equal(counts, rc)
                    and float((poses - rp).abs().max()) <= 1e-4
                    and float((scores - rs).abs().max()) <= 1e-5):
                fail('crowdpose flip-on: kernel and plain decodes differ')
            log('[crowdpose] flip-on decode: kernels and plain versions '
                'give identical counts, poses within 1e-4')

    with torch.inference_mode():
        preds = model(normalize_images(images))
        packed = pp.decode_packed_limbs(preds).contiguous()
    maps, bm = crowdpose_selection_maps(model, dev)
    b, h, w = maps.shape
    v, ys, xs = peaks.peaks_topk(maps, TOPK)
    pv, pys, pxs = peaks.peaks_topk_plain(maps, TOPK)
    if not (torch.equal(ys, pys) and torch.equal(xs, pxs)
            and torch.equal(bits(v), bits(pv))):
        fail('peaks kernel differs from plain on the CrowdPose maps')
    H, W = h * STRIDE, w * STRIDE
    peaks_rec = dict(
        shape=[b, h, w], ms=cuda_time(lambda: peaks.peaks_topk(maps, TOPK),
                                      20),
        plain_ms=cuda_time(lambda: peaks.peaks_topk_plain(maps, TOPK), 5),
        library_ms=cuda_time(lambda: library_peaks(maps), 10),
        bound=(maps.numel() * 4 + b * TOPK * 12,
               b * (7 * H * w + 16 * H * W + 4 * (H // 2) * (W // 2))))
    records['peaks']['crowdpose'] = peaks_rec

    cfg = pp.cfg
    err = compare_grouping('[crowdpose] grouping (general build)', packed, sk,
                           cfg, n_keypoints=J14)
    r = records['grouping']
    r['max_abs_err'] = max(r['max_abs_err'], err)
    # the same limbs through the J = 17 build: joints 14-16 never filled
    ms17 = cuda_time(lambda: grouping.group_skeletons(packed, sk, cfg, 17),
                     20)
    crowd = torch.from_numpy(crowd_limbs(N_IMG, CROWD_K, seed=14, L=L17,
                                         skeleton=sk)).to(dev)
    ccfg = crowd_case(dev)[1]
    r['max_abs_err'] = max(r['max_abs_err'], compare_grouping(
        '[crowdpose] grouping crowd (general build)', crowd, sk, ccfg,
        n_keypoints=J14))
    M, MP, K = cfg.capacity, cfg.max_poses, packed.shape[2]
    n = packed.shape[0]
    group_rec = dict(
        shape=list(packed.shape), build='group_kernel<0> (J = 14)',
        library_ms=None,
        ms=cuda_time(lambda: grouping.group_skeletons(packed, sk, cfg, J14),
                     20),
        ms_same_limbs_j17_build=ms17,
        plain_ms=cuda_time(lambda: plain.group_skeletons(packed, sk, cfg,
                                                         J14), 3, warmup=1),
        ms_crowd_128=cuda_time(lambda: grouping.group_skeletons(
            crowd, sk, ccfg, J14, ccfg.capacity), 20),
        plain_ms_crowd_128=cuda_time(lambda: plain.group_skeletons(
            crowd, sk, ccfg, J14, ccfg.capacity), 3, warmup=1),
        bound=(packed.numel() * 4 + n * MP * (J14 * 6 + 1) * 4 + n * 4,
               n * (L17 + cfg.settle_passes)
               * (K ** 2 + 4 * M * K + M * M * J14 // 2)))
    group_rec.update(launch_split(lambda: grouping.group_skeletons(
        packed, sk, cfg, J14), parts=('group',)))
    r['crowdpose'] = group_rec

    tv, ti = topk.topk(bm, TOPK)
    pv, pi = topk.topk_plain(bm, TOPK)
    nv, ni = nms_topk.nms_topk(maps, TOPK)
    qv, qi = nms_topk.nms_topk_plain(maps, TOPK)
    if not (torch.equal(ti, pi) and torch.equal(bits(tv), bits(pv))
            and torch.equal(ni, qi) and torch.equal(bits(nv), bits(qv))):
        fail('a selection kernel differs from plain on the CrowdPose maps')
    records['topk']['crowdpose'] = dict(
        shape=list(bm.shape), ms=cuda_time(lambda: topk.topk(bm, TOPK), 20),
        plain_ms=cuda_time(lambda: topk.topk_plain(bm, TOPK), 5),
        library_ms=cuda_time(lambda: torch.topk(bm, TOPK), 20),
        bound=(bm.numel() * 4 + bm.shape[0] * TOPK * 8, bm.numel()))
    records['nms_topk']['crowdpose'] = dict(
        shape=[b, h, w], ms=cuda_time(lambda: nms_topk.nms_topk(maps, TOPK),
                                      20),
        plain_ms=cuda_time(lambda: nms_topk.nms_topk_plain(maps, TOPK), 5),
        library_ms=cuda_time(lambda: library_nms_topk(maps), 20),
        bound=(maps.numel() * 4 + b * TOPK * 12, 10 * maps.numel()))
    for key in KERNELS:
        rec = records[key]['crowdpose']
        nb, no = rec.pop('bound')
        rec['bound_ms'] = max(nb / PEAK_BYTES, no / PEAK_FP32_FLOPS) * 1e3
        lib = rec['library_ms']
        log(f'[crowdpose] {key} {tuple(rec["shape"])} k={TOPK}: kernel '
            f'{rec["ms"]:.4f} ms, plain {rec["plain_ms"]:.4f} ms, library '
            f'{"none" if lib is None else f"{lib:.4f} ms"}, bound '
            f'{rec["bound_ms"]:.6f} ms; identical to plain')
    log(f'[crowdpose] grouping general build {group_rec["ms"]:.4f} ms '
        f'({split_text({"group_ms": group_rec["group_ms"]})}) against the '
        f'J = 17 build on the same limbs {ms17:.4f} ms; crowd '
        f'{tuple(crowd.shape)} capacity 128: {group_rec["ms_crowd_128"]:.4f}'
        f' ms, plain {group_rec["plain_ms_crowd_128"]:.4f} ms | '
        f'{card_line()}')
    del model, infer, infers, preds, maps, bm
    torch.cuda.empty_cache()
    return launches


def crowdpose_set(root, scenes, ext='npy'):
    """CrowdPose annotations of `scenes` under `root`, and for .npy seeded
    noise images of 320x256 with each person's joints painted: (image
    dir, annotation file)."""
    ann, gt = crowdpose_annotations(scenes, ext=ext)
    img_dir = os.path.join(root, 'images')
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(len(scenes))
    for im in ann['images']:
        img = (rng.rand(256, 320, 3) * 80 + 80).astype(np.uint8)
        for x, y, _ in gt[im['id']].reshape(-1, 3):
            img[max(int(y) - 2, 0):int(y) + 3,
                max(int(x) - 2, 0):int(x) + 3] = (60, 200, 60)
        np.save(os.path.join(img_dir, im['file_name']), img)
    path = os.path.join(root, 'annotations.json')
    with open(path, 'w') as f:
        json.dump(ann, f)
    return img_dir, path


def phase_crowdpose_oracle(dev, root):
    """The CrowdPose GT oracle on 99 scenes (33 a crowdIndex band):
    upsampled (peaks + grouping) and stride-resolution (NMS + top-k +
    grouping) decode on the card, each path with its launches; AP and the
    three band APs equal the same loop's on the CPU's plain versions."""
    import torch
    ann = crowdpose_set(os.path.join(root, 'cp_oracle'), crowdpose_scenes(
        CROWDPOSE_ORACLE_IMAGES, seed=0))[1]
    launches = {}
    for name, up, need in (('upsampled', True, ('peaks', 'grouping')),
                           ('lowres', False, ('nms_topk', 'grouping'))):
        path = f'crowdpose_oracle_{name}'
        t0 = time.perf_counter()
        ours, stats, launches[path] = crowdpose_oracle(ann, dev, up)
        dt = time.perf_counter() - t0
        _, ref, _ = crowdpose_oracle(ann, torch.device('cpu'), up)
        check_launches(path, launches[path], need)
        text = lambda st: ', '.join(f'{k} {v:.4f}' for k, v in st.items())
        log(f'[crowdpose oracle] {name} decode, {CROWDPOSE_ORACLE_IMAGES} '
            f'scenes: card (kernels) {text(stats)} in {dt:.1f} s; CPU '
            f'(plain) {text(ref)}; kernel launches {launches[path]}')
        if stats != ref:
            fail(f'crowdpose oracle {name}: card {stats} != CPU {ref}')
        if min(stats.values()) <= 0.5:
            fail(f'crowdpose oracle {name}: a band AP at or below 0.5 '
                 f'{stats}')
    return launches


# The crowd-scale stress set (`data/synthetic.py::make_crowd_dataset`, 30
# scenes of 640^2, 50-70 people each, seed 0) through `cli.simulate` at the
# recorded crowd sweep's settings (BENCHMARKS.md, round 5): capacity /
# max_poses -> the JAX package's AP, its `og-simulate` on the CPU (f32,
# its XLA grouping) with the same flags on its own generator's set.
CROWD_ORACLE_IMAGES = 30
CROWD_ORACLE_ARGS = ['--topk', '80', '--max-persons', '70']
CROWD_ORACLE_AP = {(16, 40): 0.2491, (32, 40): 0.3243, (64, 20): 0.2646,
                   (64, 40): 0.3243, (64, 80): 0.3243, (256, 80): 0.3231}
CROWD_ORACLE_EXACT = ((16, 40), (256, 80))     # kernel records == plain's
# the first 16 hex digits of the SHA-256 of the set's annotations.json,
# the JAX generator's file (tests/test_torch_port_synthetic.py)
CROWD_ANN_DIGEST = 'c4985c351778727f'


@contextlib.contextmanager
def captured_records():
    """[(image_id, records)] of every `poses_to_coco_results` call made
    inside the block (`cli.simulate` makes one an image)."""
    from offsetguided_tpu_torch.eval import harness
    make, got = harness.poses_to_coco_results, []

    def capture(poses, image_id):
        out = make(poses, image_id)
        got.append((image_id, out))
        return out
    harness.poses_to_coco_results = capture
    try:
        yield got
    finally:
        harness.poses_to_coco_results = make


def crowd_oracle_limbs(dev, ann, n: int = N_IMG):
    """The packed limbs (n, 19, 80, 13) of the first `n` crowd scenes'
    encoded GT, as `cli.simulate` decodes them one at a time."""
    import torch
    from offsetguided_tpu_torch.config.defaults import (
        DecoderConfig, EncoderConfig, SkeletonConfig)
    from offsetguided_tpu_torch.data import transforms as T
    from offsetguided_tpu_torch.data.coco import CocoJson
    from offsetguided_tpu_torch.decoder import PostProcessor
    from offsetguided_tpu_torch.ops.encoder import encode_targets
    skeleton, enc = SkeletonConfig(), EncoderConfig(max_persons=70)
    coco = CocoJson(ann)
    padded = np.zeros((n, enc.max_persons, J, 4), np.float32)
    for i, img_id in enumerate(coco.image_ids(with_persons=True,
                                              with_keypoints=True)[:n]):
        anns = T.normalize_annotations(coco.anns_for_image(img_id),
                                       skeleton.sigmas)[:enc.max_persons]
        padded[i, :len(anns)] = anns       # 640^2 scenes: no rescale or pad
    with torch.inference_mode():
        t = encode_targets(torch.from_numpy(padded).to(dev), skeleton.sigmas,
                           skeleton.skeleton, LONG_EDGE // STRIDE,
                           LONG_EDGE // STRIDE, enc)
        pp = PostProcessor(skeleton=skeleton, cfg=DecoderConfig(
            topk=80, thre_hmp=0.1, dist_max=40.0, use_scale=False,
            person_thre=0.1))
        return pp.decode_packed_limbs({'hmp': [t.hmp], 'jomp': [t.jomp],
                                       'omp': [t.omp], 'scmp': [None]}
                                      ).contiguous(), pp.cfg


def phase_crowd_oracle(dev, root, skeleton, records):
    """The crowd set, built here with the port's generator and codec, then
    `cli.simulate` at each capacity / max_poses of CROWD_ORACLE_AP
    (upsampled decode, batch 1: peaks + grouping kernels), each within
    0.002 of the JAX package's AP; at CROWD_ORACLE_EXACT the kernels'
    records on every scene equal the plain versions' on the card. Then the
    grouping kernel against plain on eight scenes' limbs at 16 / 40 and
    256 / 80, timed."""
    import hashlib
    import torch
    from offsetguided_tpu_torch.cli import simulate
    from offsetguided_tpu_torch.data import synthetic
    from offsetguided_tpu_torch.ops import grouping as plain
    from offsetguided_tpu_torch.ops.cuda import grouping

    t0 = time.perf_counter()
    img_dir, ann = synthetic.make_crowd_dataset(
        os.path.join(root, 'crowd'), n_images=CROWD_ORACLE_IMAGES, seed=0)
    dt = time.perf_counter() - t0
    with open(ann, 'rb') as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    n_jpeg = len([f for f in os.listdir(img_dir) if f.endswith('.jpg')])
    with open(ann) as f:
        n_people = len(json.load(f)['annotations'])
    log(f'[crowd oracle] make_crowd_dataset: {n_jpeg} painted JPEGs, '
        f'{n_people} people in {dt:.1f} s on this host; annotations digest '
        f'{digest} (the JAX generator\'s {CROWD_ANN_DIGEST})')
    if digest != CROWD_ANN_DIGEST or n_jpeg != CROWD_ORACLE_IMAGES:
        fail('[crowd oracle] the crowd set differs from the JAX generator\'s')
    launches = {}
    for (cap, mp), want in CROWD_ORACLE_AP.items():
        argv = (['--annotation-file', ann] + CROWD_ORACLE_ARGS
                + ['--capacity', str(cap), '--max-poses', str(mp)])
        path = f'crowd_oracle_{cap}_{mp}'
        reset_launches()
        t0 = time.perf_counter()
        with captured_records() as ours:
            stats = simulate.main(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[path] = read_launches()
        log(f'[crowd oracle] capacity {cap}, max_poses {mp}: AP '
            f'{stats["AP"]:.4f} (JAX CPU f32 {want:.4f}), AR '
            f'{stats["AR"]:.4f}, {dt:.1f} s, kernel launches '
            f'{launches[path]}')
        check_launches(path, launches[path], ('peaks', 'grouping'))
        if not abs(stats['AP'] - want) <= 0.002:
            fail(f'crowd oracle {cap}/{mp}: AP {stats["AP"]:.4f} is not '
                 f'within 0.002 of {want}')
        if (cap, mp) in CROWD_ORACLE_EXACT:
            with plain_kernels(), captured_records() as ref:
                simulate.main(argv)
            if ours != ref:
                bad = [i for (i, a), (_, b) in zip(ours, ref) if a != b]
                fail(f'crowd oracle {cap}/{mp}: kernel and plain records '
                     f'differ on images {bad}')
            log(f'[crowd oracle] capacity {cap}, max_poses {mp}: kernel and '
                f'plain records identical on all {len(ours)} scenes '
                f'({sum(len(r) for _, r in ours)} records)')

    packed, cfg = crowd_oracle_limbs(dev, ann)
    rec = dict(shape=list(packed.shape))
    r = records['grouping']
    for cap, mp in CROWD_ORACLE_EXACT:
        c = dataclasses.replace(cfg, capacity=cap, max_poses=mp)
        r['max_abs_err'] = max(r['max_abs_err'], compare_grouping(
            f'[crowd oracle] grouping capacity {cap}, max_poses {mp}', packed,
            skeleton, c, exact=True))
        rec[f'ms_{cap}_{mp}'] = cuda_time(lambda: grouping.group_skeletons(
            packed, skeleton, c, capacity=cap), 20)
        rec[f'plain_ms_{cap}_{mp}'] = cuda_time(lambda: plain.group_skeletons(
            packed, skeleton, c, J, cap), 3, warmup=1)
    r['crowd_oracle'] = rec
    log(f'[crowd oracle] grouping on {tuple(packed.shape)} crowd limbs: '
        + ', '.join(f'{cap} / {mp}: kernel {rec[f"ms_{cap}_{mp}"]:.4f} ms, '
                    f'plain {rec[f"plain_ms_{cap}_{mp}"]:.4f} ms'
                    for cap, mp in CROWD_ORACLE_EXACT)
        + f'; {card_line()}')
    return launches


def phase_transforms():
    """The JAX package's optional transforms on this host (no cv2 here):
    `blur`, `jpeg_compression` and `ImageList` give cv2's pixels, as the
    digests pinned on the CPU say; the host ms of `blur` at 480x640."""
    from offsetguided_tpu_torch.data import pixels
    with tempfile.TemporaryDirectory() as root:
        cases = transform_cases(root)
    for name, px in cases:
        if pixel_digest(px) != TRANSFORM_DIGESTS[name]:
            fail(f'[transforms] {name}: digest {pixel_digest(px)}, pinned '
                 f'(cv2) {TRANSFORM_DIGESTS[name]}')
    log(f'[transforms] {len(cases)} outputs (blur at '
        f'{", ".join(f"{h}x{w}" for h, w in BLUR_SIZES)}, 1 and 3 channels, '
        f'sigma {", ".join(map(str, BLUR_SIGMAS))}; jpeg_compression; '
        f'ImageList JPEG with EXIF orientation 6 and PNG): equal to cv2\'s '
        f'pinned digests')
    for c in (3, 1):
        img = transform_image(480, 640, c, seed=2)
        for sigma in BLUR_SIGMAS:
            ts = []
            for _ in range(7):
                t0 = time.perf_counter()
                pixels.gaussian_blur_u8(img, sigma)
                ts.append(time.perf_counter() - t0)
            log(f'[transforms] blur 480x640x{c} sigma {sigma}: median '
                f'{np.median(ts) * 1e3:.2f} ms, min {min(ts) * 1e3:.2f} ms on '
                f'one host thread (numpy)')


def phase_crowdpose_evaluate(dev, root):
    """`cli.evaluate --dataset crowdpose` at full width on 16 seeded .npy
    CrowdPose scenes (crowdIndex in each band), batch 8: `--fixed-height
    --flip-test` (block top-k + grouping) and `--lowres-decode` (NMS +
    top-k + grouping), each with its launches; the four band APs."""
    import torch
    from offsetguided_tpu_torch.cli import evaluate
    img_dir, ann = crowdpose_set(os.path.join(root, 'cp_eval'),
                                 crowdpose_scenes(16, seed=3))
    base = ['--image-dir', img_dir, '--annotation-file', ann, '--dataset',
            'crowdpose', '--batch-size', str(N_IMG)]
    paths = {
        'crowdpose_eval_fixed_height': (['--fixed-height', '--flip-test'],
                                        ('topk', 'grouping'),
                                        ('peaks', 'nms_topk')),
        'crowdpose_eval_lowres': (['--lowres-decode'],
                                  ('nms_topk', 'grouping'),
                                  ('peaks', 'topk')),
    }
    launches = {}
    for path, (extra, need, never) in paths.items():
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        stats = evaluate.main(base + extra)
        torch.cuda.synchronize()
        launches[path] = read_launches()
        if list(stats)[:4] != ['AP', 'AP_easy', 'AP_medium', 'AP_hard'] or \
                not all(np.isfinite(v) for v in stats.values()):
            fail(f'{path}: metrics {stats}')
        check_launches(path, launches[path], need, never)
        log(f'[crowdpose evaluate] {path}: 16 images, '
            f'{stats["img_per_s"]:.2f} img/s (host clock), AP '
            f'{stats["AP"]:.4f}, easy {stats["AP_easy"]:.4f}, medium '
            f'{stats["AP_medium"]:.4f}, hard {stats["AP_hard"]:.4f} (random '
            f'weights), peak memory '
            f'{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB, '
            f'kernel launches {launches[path]}')
    return launches


def phase_crowdpose_serve_http(dev):
    """8 concurrent POSTs against `cli.serve --dataset crowdpose`: every
    answer 200 with poses of 14 keypoints, peaks + grouping launched."""
    from offsetguided_tpu_torch.cli.bench_serve import make_test_jpegs
    path = 'crowdpose_serve_http'
    return {path: serve_burst(dev, path, ['--dataset', 'crowdpose'],
                              ('peaks', 'grouping'), ('topk', 'nms_topk'),
                              make_test_jpegs(8, seed=2), J14)}


def phase_train_4stage(dev, root):
    """`cli.train --basenet hourglass4stage` at the JAX CLI's defaults
    (512^2, batch 16, 2 stacks, Adam) on the host route with 4 loader
    processes and the validation pass, 8 steps on the 64-image hard set:
    finite losses, no skipped step, a finite validation loss; img/s, the
    step split by events and peak memory."""
    import torch
    from offsetguided_tpu_torch.cli import train
    from offsetguided_tpu_torch.data.synthetic import make_hard_dataset
    img_dir, ann = make_hard_dataset(os.path.join(root, 'train'),
                                     n_images=TRAIN_IMAGES, seed=0, ext='npy')
    val_dir, val_ann = make_hard_dataset(os.path.join(root, 'val'),
                                         n_images=VAL_IMAGES, seed=1,
                                         ext='npy')
    argv = ['--basenet', 'hourglass4stage', '--train-image-dir', img_dir,
            '--train-annotations', ann, '--val-image-dir', val_dir,
            '--val-annotations', val_ann, '--batch-size', str(TRAIN_BATCH),
            '--square-length', str(TRAIN_SIZE), '--max-steps',
            str(FOUR_STAGE_STEPS), '--loader-workers', str(LOADER_WORKERS),
            '--print-freq', '1', '--checkpoint-dir',
            os.path.join(root, 'checkpoints_4stage')]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    r = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if any(read_launches().values()):
        fail(f'training launched a decode kernel: {read_launches()}')
    for h in r['history']:
        log(f'[train 4stage] step {h["step"]}: total {h["total"]:.4f} hmp '
            f'{h["hmp"]:.4f} omp {h["omp"]:.6f} skipped {h["skipped"]:.0f}, '
            f'host wait {h["host_wait_s"]:.4f} s, feed {h["feed_ms"]:.2f} '
            f'ms, forward+backward+optimizer {h["step_ms"]:.2f} ms (CUDA '
            f'events)')
    for v in r['val']:
        log(f'[train 4stage] validation after epoch {v["epoch"]}: loss '
            f'{v["loss"]:.4f} over {v["batches"]} batch(es)')
    if not r['val'] or not all(np.isfinite(v['loss']) for v in r['val']):
        fail(f'train 4stage: validation losses {r["val"]}')
    from offsetguided_tpu_torch.models import count_params, PoseNet
    n = count_params(PoseNet(r['model_cfg']))
    train_summary('train 4stage', r['history'], wall, peak, r['checkpoint'],
                  steps=FOUR_STAGE_STEPS, falling=False,
                  net=f'Hourglass-4stage ({n / 1e6:.2f} M parameters)')
    torch.cuda.empty_cache()


def phase_train_crowdpose(dev, root):
    """`cli.train --dataset crowdpose` on full-width Hourglass-104 (14 / 17
    heads), 4 steps at 512^2, batch 16, on 64 CrowdPose scenes: finite
    losses, no skipped step."""
    import torch
    from offsetguided_tpu_torch.cli import train
    img_dir, ann = crowdpose_set(os.path.join(root, 'cp_train'),
                                 crowdpose_scenes(TRAIN_IMAGES, seed=5))
    argv = ['--dataset', 'crowdpose', '--train-image-dir', img_dir,
            '--train-annotations', ann, '--batch-size', str(TRAIN_BATCH),
            '--square-length', str(TRAIN_SIZE), '--max-steps',
            str(CROWDPOSE_TRAIN_STEPS), '--print-freq', '1',
            '--checkpoint-dir', os.path.join(root, 'checkpoints_cp')]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    r = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    heads = r['model_cfg'].heads
    if (heads.n_keypoints, heads.n_limbs) != (14, 17):
        fail(f'train crowdpose: heads {heads}')
    train_summary('train crowdpose', r['history'], wall,
                  torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                  r['checkpoint'], steps=CROWDPOSE_TRAIN_STEPS, falling=False,
                  net='Hourglass-104, CrowdPose heads 14 / 17,')
    torch.cuda.empty_cache()


FINETUNE_FREEZE = 'Hourglass104_0'     # the backbone, as the reference's
FINETUNE_DROP = 'omp_'                 # --freeze backbone / offset drop
FINETUNE_STEPS, FREEZE_TIMING_RUNS = 4, 5
LOSS_HEADS = ('headnets.0.hp_convs.', 'headnets.1.reg_convs.',
              'headnets.1.scale_convs.')


def phase_finetune(dev, root, records):
    """Fine-tuning through the CLIs a user calls, at full width: seeded
    COCO Hourglass-104 weights written as a reference `.pth` by
    `cli.export --to-torch`; `cli.train --dataset crowdpose
    --torch-checkpoint` warm-starts the 14 / 17-head net from it with
    `--freeze Hourglass104_0`, 4 steps at 512^2, batch 16, on the host
    route (64 CrowdPose scenes): the unmatched entries equal the CPU
    loader's, every frozen parameter stays bit-equal to its warm-start
    value (weight decay 0), every head moved, no step skipped; `--resume`
    of that checkpoint with `--drop-layers omp_ --drop-optim-state` for
    one more step; `cli.evaluate --checkpoint` of the result on 16
    CrowdPose scenes through the peaks and grouping kernels (the
    `finetune` path's launches), then both kernels against their plain
    versions on the fine-tuned model's maps and limbs. Last, a frozen and
    an unfrozen train step of the CrowdPose net in turns (CUDA events)."""
    import torch
    from offsetguided_tpu_torch.cli import evaluate, export, serve, train
    from offsetguided_tpu_torch.models import PoseNet
    from offsetguided_tpu_torch.models import checkpoint as ckpt
    from offsetguided_tpu_torch.models.network import init_reference_

    pth = os.path.join(root, 'coco_seeded.pth')
    export.main(['--to-torch', pth, '--input-size', str(TRAIN_SIZE)])
    torch.cuda.empty_cache()
    img_dir, ann = crowdpose_set(os.path.join(root, 'ft_train'),
                                 crowdpose_scenes(TRAIN_IMAGES, seed=7))
    base = ['--dataset', 'crowdpose', '--train-image-dir', img_dir,
            '--train-annotations', ann, '--batch-size', str(TRAIN_BATCH),
            '--square-length', str(TRAIN_SIZE), '--print-freq', '1',
            '--freeze', FINETUNE_FREEZE]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    r = train.main(base + ['--torch-checkpoint', pth, '--max-steps',
                           str(FINETUNE_STEPS), '--checkpoint-dir',
                           os.path.join(root, 'ft_warm')])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cfg = r['model_cfg']
    train_summary('finetune', r['history'], wall,
                  torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                  r['checkpoint'], steps=FINETUNE_STEPS, falling=False,
                  net='Hourglass-104 warm-started from COCO into CrowdPose '
                      'heads 14 / 17, backbone frozen,')
    start = init_reference_(PoseNet(cfg), torch.Generator().manual_seed(0))
    unmatched = ckpt.load_reference_into(start, pth)
    if r['unmatched'] != unmatched or not unmatched:
        fail(f'finetune: unmatched entries on the card {r["unmatched"]} != '
             f'the CPU loader\'s {unmatched}')
    start = dict(start.named_parameters())
    trained = {k: v.detach().cpu() for k, v in r['model'].named_parameters()}
    frozen = set(r['frozen'])
    if frozen != {k for k in start if k.startswith('basenet.')}:
        fail(f'finetune: --freeze {FINETUNE_FREEZE} froze {len(frozen)} of '
             f'{len(start)} parameters, not the backbone\'s')
    moved = [k for k in frozen if not torch.equal(trained[k], start[k])]
    # the heads with a loss weight (lambdas 1 0 0 10000 10: heatmaps,
    # offsets, scales; the background and jitter heads take no gradient)
    heads = [k for k in start if k.startswith(LOSS_HEADS)]
    still = [k for k in heads if torch.equal(trained[k], start[k])]
    if moved or still or not heads:
        fail(f'finetune: frozen parameters moved {moved[:5]}, heads that did '
             f'not move {still[:5]}')
    log(f'[finetune] warm start from {os.path.basename(pth)}: {len(unmatched)}'
        f' unmatched entries (the CPU loader\'s: {unmatched[:2]} ...); '
        f'{len(frozen)} frozen parameters bit-equal to their warm-start '
        f'values after {FINETUNE_STEPS} steps, all {len(heads)} parameters '
        f'of the weighted heads moved')
    del r
    torch.cuda.empty_cache()

    r = train.main(base + ['--resume', ckpt.latest_checkpoint(
        os.path.join(root, 'ft_warm')), '--drop-layers', FINETUNE_DROP,
        '--drop-optim-state', '--max-steps', '1', '--checkpoint-dir',
        os.path.join(root, 'ft_resume')])
    h = r['history'][-1]
    if not (np.isfinite(h['total']) and h['skipped'] == 0.0):
        fail(f'finetune resume: {h}')
    trained = {k: v.detach().cpu() for k, v in r['model'].named_parameters()}
    if [k for k in frozen if not torch.equal(trained[k], start[k])]:
        fail('finetune resume: a frozen parameter moved')
    log(f'[finetune] --resume --drop-layers {FINETUNE_DROP} '
        f'--drop-optim-state: 1 step, total {h["total"]:.4f}, step '
        f'{h["step_ms"]:.2f} ms (CUDA events), checkpoint '
        f'{os.path.basename(r["checkpoint"])}')
    final = r['checkpoint']
    del r, trained
    torch.cuda.empty_cache()

    ev_dir, ev_ann = crowdpose_set(os.path.join(root, 'ft_eval'),
                                   crowdpose_scenes(16, seed=3))
    reset_launches()
    stats = evaluate.main(['--checkpoint', final, '--dataset', 'crowdpose',
                           '--image-dir', ev_dir, '--annotation-file',
                           ev_ann, '--batch-size', str(N_IMG)])
    torch.cuda.synchronize()
    launches = read_launches()
    check_launches('finetune', launches, ('peaks', 'grouping'),
                   never=('topk', 'nms_topk'))
    if not all(np.isfinite(v) for v in stats.values()):
        fail(f'finetune evaluate: metrics {stats}')
    log(f'[finetune] evaluate --checkpoint on 16 CrowdPose scenes: AP '
        f'{stats["AP"]:.4f} (4 + 1 steps from random weights), '
        f'{stats["img_per_s"]:.2f} img/s (host clock), kernel launches '
        f'{launches}')
    args = serve.cli(['--dataset', 'crowdpose', '--checkpoint', final])
    scfg = serve.model_config(args)
    infer, skeleton, _, model = serve.build_infer(
        args, scfg, serve.load_weights(args, scfg), dev)
    images = torch.from_numpy(np.random.RandomState(12).randint(
        0, 256, (N_IMG, LONG_EDGE, LONG_EDGE, 3), dtype=np.uint8)).to(dev)
    hold_kernels('[finetune]', infer.postprocessor, model, images,
                 tuple(skeleton.skeleton), J14, records)
    del infer, model
    torch.cuda.empty_cache()
    freeze_timing(dev, cfg, img_dir, ann, sorted(frozen))
    return {'finetune': launches}


def freeze_timing(dev, cfg, img_dir, ann, frozen):
    """One CrowdPose batch (host route, as `cli.train` feeds it) and the
    train step of `cfg` unfrozen and with `frozen` in turns, on one model
    and optimizer: the ms of each by CUDA events (2 warm-up steps each)."""
    import torch
    from offsetguided_tpu_torch.cli import train
    from offsetguided_tpu_torch.config.defaults import (
        AugmentationConfig, EncoderConfig, LossConfig, SkeletonConfig,
        TrainConfig)
    from offsetguided_tpu_torch.data import pipeline
    from offsetguided_tpu_torch.models import PoseNet
    from offsetguided_tpu_torch.models.network import init_reference_
    from offsetguided_tpu_torch.parallel.train_step import (TrainStep,
                                                            make_optimizer)
    sk = SkeletonConfig.for_dataset('crowdpose')
    enc = EncoderConfig()
    ds = pipeline.CocoKeypoints(
        img_dir, ann, skeleton=sk,
        aug=AugmentationConfig(square_length=TRAIN_SIZE),
        square_length=TRAIN_SIZE)
    batch = pipeline._make_batch(ds, range(TRAIN_BATCH),
                                 pipeline._batch_rng(0, 0, 0), 0)
    imgs, targets, mask = train.device_batch(batch, ds, dev, enc, sk,
                                             TRAIN_SIZE)
    model = init_reference_(PoseNet(cfg), torch.Generator().manual_seed(0))
    model = model.to(dev, memory_format=torch.channels_last)
    opt = make_optimizer(TrainConfig(), model.parameters())
    params = dict(model.named_parameters())
    loss = LossConfig(stack_weights=(1.0,) * cfg.n_stacks)
    steps = {'unfrozen': TrainStep(model, opt, loss),
             'frozen': TrainStep(model, opt, loss,
                                 frozen=[params[k] for k in frozen])}
    ms = {k: [] for k in steps}
    for i in range(2 + FREEZE_TIMING_RUNS):
        for k, step in steps.items():
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            step(imgs, targets, mask)
            ev[1].record()
            torch.cuda.synchronize()
            if i >= 2:
                ms[k].append(ev[0].elapsed_time(ev[1]))
    med = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
    log(f'[finetune] CrowdPose train step at {TRAIN_SIZE}^2 batch '
        f'{TRAIN_BATCH}, in turns (CUDA events): unfrozen '
        f'{", ".join(f"{v:.2f}" for v in ms["unfrozen"])} ms, frozen '
        f'backbone {", ".join(f"{v:.2f}" for v in ms["frozen"])} ms; '
        f'median {med["frozen"]:.2f} / {med["unfrozen"]:.2f} = '
        f'{med["frozen"] / med["unfrozen"]:.3f} | {card_line()}')
    del model, opt, steps
    torch.cuda.empty_cache()


def phase_4stage_reference(dev):
    """The 4-stage net card vs CPU with TF32 off: the fp32 eval forward (BN
    folded) at 128^2 within 1e-3 of the heatmaps' scale, and one fp64 SGD
    step of the 1-stack net on the one-step batch (its fp32 images and
    targets made on the CPU, so both devices start from the same bits)
    within the CPU tests' tolerances; then a narrow Hourglass-104 with 3x3
    tower heads, forward card vs CPU."""
    import torch
    from offsetguided_tpu_torch.config.defaults import HeadsConfig, ModelConfig
    from offsetguided_tpu_torch.device import exact_fp32
    from offsetguided_tpu_torch.models import random_posenet
    from offsetguided_tpu_torch.ops.image import normalize_images

    cases = {
        'Hourglass-4stage, 1 stack, 128^2': (ModelConfig(
            basenet='hourglass4stage', n_stacks=1, compute_dtype='float32'),
            128),
        'tower heads (tower_dim 256) on the tiny Hourglass-104, 128^2': (
            ModelConfig(**dict(TINY_TRAIN, heads=HeadsConfig(tower=True))),
            128),
    }
    with exact_fp32():
        for what, (cfg, size) in cases.items():
            net = random_posenet(cfg, 0, device='cpu', calib_size=size,
                                 calib_batch=8).prepare_inference()
            x = normalize_images(torch.from_numpy(np.random.RandomState(
                4).randint(0, 256, (2, size, size, 3), dtype=np.uint8)))
            with torch.inference_mode():
                ref = net(x)
                got = net.to(dev)(x.to(dev))
            err = max(float((got[k][-1].cpu() - ref[k][-1]).abs().max())
                      for k in ('hmp', 'omp', 'scmp'))
            scale = float(ref['hmp'][-1].abs().max())
            log(f'[4stage reference] {what}: fp32 eval forward card vs CPU '
                f'max_abs_err {err:.3g} (max |hmp| {scale:.3g})')
            if not err <= 1e-3 * scale:
                fail(f'4stage reference: {what} card forward differs from '
                     f'the CPU by {err} (scale {scale})')
    def cpu_made_feed(where):
        images, t, mask = tiny_feed('cpu')
        return (normalize_images(images).to(where),
                type(t)(*[x.to(where) for x in t]), mask.to(where))

    e = train_one_step_errors(dev, cpu_made_feed, 'float64', dict(
        basenet='hourglass4stage', n_stacks=1))
    log(f'[4stage reference] float64 SGD step of the 1-stack 4-stage net on '
        f'the one-step batch, normalized and encoded on the CPU for both '
        f'devices (the net amplifies the last-bit differences of fp32 '
        f'inputs made on each device), card vs CPU: losses max rel err '
        f'{e["loss"]:.3g}, gradients max '
        f'(|diff| - 1e-3 |g|) {e["grad"]:.3g} of the largest gradient '
        f'{e["grad_max"]:.3g}, BN statistics max abs err {e["bn"]:.3g}')
    if not one_step_ok(e):
        fail('4stage reference: card and CPU steps differ past the CPU '
             'tests\' tolerances')


# --------------------------------------------------------------------------- #
# the custom ops' dispatch, the demo, export and the training benchmarks
# --------------------------------------------------------------------------- #
@contextlib.contextmanager
def direct_kernels():
    """The peaks and grouping wrappers calling their ops' CUDA
    implementations directly, past the custom-op dispatcher: the decode's
    path before the kernels became custom ops (one ctypes call each)."""
    from offsetguided_tpu_torch.ops.cuda import grouping, peaks

    def peaks_direct(maps, k, method='bicubic'):
        return peaks._peaks_topk_cuda(maps, k, method)

    def group_direct(packed, skeleton, cfg, n_keypoints=17, capacity=64):
        return grouping._group_cuda(
            packed, [j for pair in skeleton for j in pair], n_keypoints,
            capacity, cfg.max_poses, cfg.settle_passes, cfg.sort_dim,
            bool(cfg.use_scale), float(cfg.dist_max), float(cfg.person_thre))

    peaks_direct.launches = group_direct.launches = 0
    saved = (peaks.peaks_topk, grouping.group_skeletons)
    peaks.peaks_topk, grouping.group_skeletons = peaks_direct, group_direct
    try:
        yield
    finally:
        peaks.peaks_topk, grouping.group_skeletons = saved


def host_us(fn, n: int = 200) -> float:
    """Host microseconds a call of `fn` (enqueue only: the card runs
    behind), after a synchronized warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def phase_dispatch(serve, images):
    """What the custom ops cost the serving path: [full]'s flip-off img/s
    (host clock over 5 batches after one) through the ops and through
    their CUDA implementations called directly, in turns (ops, direct,
    direct, ops), and the host's microseconds a wrapper call on the main
    path's inputs, op against direct."""
    import torch
    from offsetguided_tpu_torch.ops.cuda import grouping, peaks
    from offsetguided_tpu_torch.ops.image import normalize_images

    infer, _, _, model = serve
    pp = infer.postprocessor

    def rate():
        infer(images)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            infer(images)
        torch.cuda.synchronize()
        return N_IMG * 5 / (time.perf_counter() - t0)

    turns = []
    for mode in ('ops', 'direct', 'direct', 'ops'):
        if mode == 'ops':
            turns.append((mode, rate()))
        else:
            with direct_kernels():
                turns.append((mode, rate()))
    with torch.inference_mode():
        preds = model(normalize_images(images))
        hmp = pp.select_stage(preds)['hmp']
        n, h, w, c = hmp.shape
        maps = hmp.permute(0, 3, 1, 2).reshape(n * c, h, w).contiguous()
        packed = pp.decode_packed_limbs(preds).contiguous()
    skeleton = tuple(zip(pp._jf.tolist(), pp._jt.tolist()))
    flat = [j for pair in skeleton for j in pair]
    cfg = pp.cfg
    calls = {
        'peaks op': lambda: peaks.peaks_topk(maps, TOPK),
        'peaks direct': lambda: peaks._peaks_topk_cuda(maps, TOPK, 'bicubic'),
        'grouping op': lambda: grouping.group_skeletons(packed, skeleton,
                                                        cfg),
        'grouping direct': lambda: grouping._group_cuda(
            packed, flat, J, cfg.capacity, cfg.max_poses, cfg.settle_passes,
            cfg.sort_dim, bool(cfg.use_scale), float(cfg.dist_max),
            float(cfg.person_thre)),
    }
    us = {k: host_us(fn) for k, fn in calls.items()}
    mean = lambda m: np.mean([r for k, r in turns if k == m])
    log('[dispatch] [full] flip off in turns: '
        + ', '.join(f'{k} {r:.2f}' for k, r in turns)
        + f' img/s (ops mean {mean("ops"):.2f}, direct mean '
        f'{mean("direct"):.2f}); host us a call: '
        + ', '.join(f'{k} {v:.1f}' for k, v in us.items())
        + f' | {card_line()}')


DEMO_IMAGES = 4
DEMO_FLAGS = ['--flip-test', '--show-heatmaps', '--show-limb-offsets', '0',
              '--show-all-limbs']


def phase_demo(dev, root):
    """`cli.demo.main` at full width (random seeded weights calibrated at
    640^2, as `cli.serve` makes them) on four painted hard-set JPEGs with
    flip test, heatmaps, limb offsets, all limbs and the annotation file.
    Each image's poses must equal what `cli.serve.build_infer` gives for
    the same image and weights (its decoder at the demo's settings), every
    PNG must decode through the codec at its size, the losses must be
    finite, and the path must launch the peaks, grouping and (all limbs)
    block top-k kernels. Returns {'demo': launches}."""
    import torch
    from offsetguided_tpu_torch.cli import demo
    from offsetguided_tpu_torch.cli.serve import build_infer, cli
    from offsetguided_tpu_torch.data import codec
    from offsetguided_tpu_torch.data import transforms as T
    from offsetguided_tpu_torch.data.synthetic import make_hard_dataset
    from offsetguided_tpu_torch.eval.harness import preprocess_eval

    img_dir, ann = make_hard_dataset(os.path.join(root, 'demo'),
                                     n_images=DEMO_IMAGES, seed=3, ext='jpg')
    paths = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir))
    out_dir = os.path.join(root, 'demo_out')
    torch.cuda.empty_cache()
    reset_launches()
    t0 = time.perf_counter()
    results = demo.main(paths + DEMO_FLAGS + ['--annotation-file', ann,
                                              '--output-dir', out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    check_launches('demo', launches, ('peaks', 'grouping', 'topk'),
                   never=('nms_topk',))

    infer, _, eval_cfg, _ = build_infer(cli(
        ['--flip-test', '--topk', '48', '--thre-hmp', '0.06', '--dist-max',
         '20', '--person-thre', '0.06']), device=dev, seed=0)
    n_poses = []
    for path, r in zip(paths, results):
        raw = codec.imread(path)
        img, _, meta = preprocess_eval(raw, np.zeros((0, J, 4), np.float32),
                                       eval_cfg)
        poses, _, counts = infer(torch.from_numpy(img[None]).to(dev))
        want = T.annotations_inverse(
            poses[0, :int(counts[0])].cpu().numpy(), meta)
        if not np.array_equal(want, r['poses']):
            fail(f'demo: {os.path.basename(path)} poses differ from '
                 f'build_infer\'s')
        if r['losses'] is None or not all(np.isfinite(v) for v in
                                          r['losses'].values()):
            fail(f'demo: {os.path.basename(path)} losses {r["losses"]}')
        for f in r['files']:
            png = codec.imread(f)
            size = raw.shape if f.endswith('.poses.png') else img.shape
            if png is None or png.shape != size:
                fail(f'demo: {f} does not decode at {size}')
        n_poses.append(len(r['poses']))
    log(f'[demo] Hourglass-104 on {len(paths)} hard-set JPEGs with '
        f'{" ".join(DEMO_FLAGS)}: {wall:.1f} s ({wall / len(paths):.2f} s an '
        f'image, model build included), poses {n_poses} equal to '
        f'build_infer\'s, {sum(len(r["files"]) for r in results)} PNGs '
        f'decoded, losses of image 1 '
        f'{ {k: round(v, 4) for k, v in results[0]["losses"].items()} }, '
        f'kernel launches {launches}')
    return {'demo': launches}


HG104_PARAMS_M = 187.7        # Hourglass-104 with its heads, millions
EXPORT_LOAD = """
import json, sys, time
import numpy as np, torch
import offsetguided_tpu_torch.ops.cuda
from offsetguided_tpu_torch.ops.cuda import grouping, nms_topk, peaks, topk
t0 = time.perf_counter()
program = torch.export.load(sys.argv[1]).module()
load_s = time.perf_counter() - t0
x = torch.from_numpy(np.load(sys.argv[2])).to(sys.argv[4])
with torch.inference_mode():
    t0 = time.perf_counter()
    out = program(x)
    if x.is_cuda:
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
np.savez(sys.argv[3], *[t.cpu().numpy() for t in out])
print(json.dumps({'load_s': load_s, 'first_run_s': first_s, 'launches': {
    'peaks': peaks.peaks_topk.launches,
    'grouping': grouping.group_skeletons.launches,
    'topk': topk.topk.launches, 'nms_topk': nms_topk.nms_topk.launches}}))
"""


def phase_export(dev, root):
    """`cli.export.main` at full width, batch 1, 512^2, with the decode:
    the parameters per top module, the GMACs beside the reference's thop
    234.5, the seconds of `torch.export`; the program holds the peaks and
    grouping custom ops; saved, then loaded and run in a fresh process on
    the card, its poses, scores and counts bit-equal to the eager forward
    + decode on the same input, with the kernels' launches counted there.
    Returns {'export_pt2': the fresh process's launches}."""
    import torch
    from offsetguided_tpu_torch.cli import export
    from offsetguided_tpu_torch.config.defaults import DecoderConfig
    from offsetguided_tpu_torch.decoder import PostProcessor
    from offsetguided_tpu_torch.ops.image import normalize_images

    path = os.path.join(root, 'hourglass104.pt2')
    torch.cuda.empty_cache()
    r = export.main(['--input-size', '512', '--batch-size', '1',
                     '--with-decode', '--output', path])
    params = r['params']
    if abs(params['TOTAL'] / 1e6 - HG104_PARAMS_M) > 0.1:
        fail(f'export: {params["TOTAL"]} parameters, not {HG104_PARAMS_M} M')
    targets = {str(n.target) for n in r['program'].graph.nodes
               if n.op == 'call_function'}
    need = {'offsetguided.peaks_topk.default',
            'offsetguided.group_skeletons.default'}
    if not need <= targets:
        fail(f'export: the program lacks {need - targets}')
    x = normalize_images(torch.from_numpy(np.random.RandomState(9).randint(
        0, 256, (1, 512, 512, 3), dtype=np.uint8)).to(dev))
    with torch.inference_mode():
        eager = export.Forward(r['model'], PostProcessor(cfg=DecoderConfig()))(
            x)
    x_path, out_path = (os.path.join(root, 'export_x.npy'),
                        os.path.join(root, 'export_out.npz'))
    np.save(x_path, x.cpu().numpy())
    del r
    torch.cuda.empty_cache()
    proc = subprocess.run(
        [sys.executable, '-c', EXPORT_LOAD, path, x_path, out_path,
         str(dev)],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        fail(f'export: loading the program in a fresh process failed:\n'
             f'{proc.stderr[-3000:]}')
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    got = np.load(out_path)
    for i, name in enumerate(('poses', 'scores', 'counts')):
        a, b = got[f'arr_{i}'], eager[i].cpu().numpy()
        if not (a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a.view(np.uint8), b.view(np.uint8))):
            fail(f'export: the loaded program\'s {name} differ from eager')
    check_launches('export_pt2', info['launches'], ('peaks', 'grouping'),
                   never=('topk', 'nms_topk'))
    log(f'[export] counts {eager[2].tolist()}: the program run in a fresh '
        f'process (load {info["load_s"]:.1f} s, first run '
        f'{info["first_run_s"]:.2f} s) bit-equal to eager, kernel launches '
        f'there {info["launches"]}; .pt2 {os.path.getsize(path) / 1e6:.1f} MB')
    return {'export_pt2': info['launches']}


def phase_bench_train():
    """`cli.bench_train` at the JAX tool's defaults (Hourglass-104, 512^2,
    batch 16, Adam): device-resident data, then the device augmentation on
    the patch and on the tiled warp. No decode kernel runs."""
    import torch
    from offsetguided_tpu_torch.cli import bench_train

    for extra in ([], ['--device-aug', '--warp-impl', 'patch'],
                  ['--device-aug', '--warp-impl', 'tiled']):
        torch.cuda.empty_cache()
        reset_launches()
        out = bench_train.main(extra)
        if any(read_launches().values()):
            fail(f'bench_train launched a decode kernel: {read_launches()}')
        if not out['value'] > 0:
            fail(f'bench_train: {out}')
        c = out['config']
        log(f'[bench_train] device_aug {c["device_aug"]} warp '
            f'{c["warp_impl"]}: {out["value"]} img/s, {c["step_ms"]} ms a '
            f'step (host clock: the fastest of {c["repeats"]} 9-step runs '
            f'less the fastest 3-step run, in turns) | '
            f'{card_line()}')
    torch.cuda.empty_cache()


def phase_bench_warp():
    """`cli.bench_warp --full` at the JAX tool's defaults (16 x 640^2 ->
    512^2, 4 channels, slope bound 3, tiles 8 x 64): both warps and the
    whole `augment_batch`, tiled within the JAX package's tolerance of
    patch; then the tiled warp at 8 x 16 tiles."""
    import torch
    from offsetguided_tpu_torch.cli import bench_warp

    torch.cuda.empty_cache()
    out = bench_warp.main(['--full'])
    if not out['within_tolerance']:
        fail(f'bench_warp: tiled differs from patch past rtol 1e-3 / atol '
             f'0.05 (max {out["max_abs_diff"]})')
    small = bench_warp.main(['--impls', 'tiled', '--lane-chunk', '16'])
    log(f'[bench_warp] ms a batch (CUDA events): warp '
        f'{ {k: round(v, 3) for k, v in out["warp_ms"].items()} }, '
        f'augment_batch '
        f'{ {k: round(v, 3) for k, v in out["augment_batch_ms"].items()} }; '
        f'max |patch - tiled| {out["max_abs_diff"]:.4f}; tiled at 8 x 16 '
        f'tiles {small["warp_ms"]["tiled"]:.3f} ms | {card_line()}')
    torch.cuda.empty_cache()


def phase_bench_stem():
    """`cli.bench_stem` at the JAX tool's shape (batch 8, 640^2, 128
    features, bf16): every formulation within its tolerance of `plain`, in
    NCHW and channels_last."""
    from offsetguided_tpu_torch.cli import bench_stem

    out = bench_stem.main([])
    bad = [k for k, ok in out['ok'].items() if not ok]
    if bad:
        fail(f'bench_stem: {bad} differ from plain: {out["max_abs_err"]}')
    log(f'[bench_stem] ms (CUDA events): '
        f'{ {k: round(v, 4) for k, v in out["ms"].items()} } | '
        f'{card_line()}')



def timed(phase, *args):
    """`phase(*args)`, its seconds logged as a `[time]` line."""
    t0 = time.perf_counter()
    out = phase(*args)
    log(f'[time] {phase.__name__[len("phase_"):]} '
        f'{time.perf_counter() - t0:.1f} s')
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        fail('torch is not installed')
    if not torch.cuda.is_available():
        fail('no CUDA device: this smoke run needs the card')
    dev = torch.device('cuda', 0)
    t_start = time.perf_counter()
    log(card_line())
    log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}')

    from offsetguided_tpu_torch.config import COCO_PERSON_SKELETON
    skeleton = tuple(COCO_PERSON_SKELETON)
    records = {}
    timed(phase_build)
    timed(phase_codec)
    timed(phase_transforms)
    timed(phase_peaks, dev, skeleton, records)
    timed(phase_grouping, dev, skeleton, records)
    launches, serve, images = timed(phase_full_width, dev)
    timed(phase_dispatch, serve, images)
    timed(phase_main_path_kernels, skeleton, serve, images, records)
    timed(phase_reference, dev, serve)
    launches['batcher'] = timed(phase_batcher, dev, serve)
    timed(phase_topk, dev, serve, records)
    timed(phase_nms_topk, dev, serve, records)
    timed(phase_large_k, dev)
    del serve, images
    torch.cuda.empty_cache()
    launches.update(timed(phase_crowdpose, dev, records))
    launches.update(timed(phase_serve_http, dev))
    launches.update(timed(phase_crowdpose_serve_http, dev))
    launches.update(timed(phase_bench))
    timed(phase_bench_serve)
    with tempfile.TemporaryDirectory() as root:
        launches.update(timed(phase_bench_e2e, root))
        launches.update(timed(phase_tools_profile))
        launches.update(timed(phase_demo, dev, root))
        launches.update(timed(phase_export, dev, root))
        launches.update(timed(phase_evaluate, dev, root))
        launches.update(timed(phase_crowdpose_evaluate, dev, root))
        launches.update(timed(phase_oracle, dev, root))
        launches.update(timed(phase_crowdpose_oracle, dev, root))
        launches.update(timed(phase_crowd_oracle, dev, root, skeleton,
                              records))
        torch.cuda.empty_cache()
        launches.update(timed(phase_train, dev, root, skeleton, records))
        timed(phase_train_host, dev, root)
        timed(phase_train_4stage, dev, root)
        timed(phase_train_crowdpose, dev, root)
        launches.update(timed(phase_finetune, dev, root, records))
        launches.update(timed(phase_selfcheck, dev, root))
        timed(phase_train_one_step, dev, root)
        timed(phase_ddp, dev, root)
        timed(phase_ddp_one_step, dev)
        timed(phase_dryrun)
        timed(phase_4stage_reference, dev)
        timed(phase_bench_train)
        timed(phase_bench_warp)
        timed(phase_bench_stem)

    kernels = []
    for key in KERNELS:
        r = records[key]
        n_bytes, n_ops = r.pop('bound')
        t_bytes = n_bytes / PEAK_BYTES * 1e3
        t_ops = n_ops / PEAK_FP32_FLOPS * 1e3
        by_path = {path: n[key] for path, n in launches.items()}
        kernels.append(dict(
            r, launches=sum(by_path.values()), launches_by_path=by_path,
            bound_ms=max(t_bytes, t_ops),
            bound_by='bytes' if t_bytes >= t_ops else 'operations'))
    log(f'[done] every phase passed in {time.perf_counter() - t_start:.1f} '
        f's')
    log(card_line())
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
