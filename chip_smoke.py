#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from `offsetguided_tpu_torch/csrc/`, holds each
against its plain PyTorch version at the main path's shapes, serves the full
Hourglass-104 (random seeded weights, 640x640, batch 8, bf16) with flip-test
off and on through the port's entry points, and answers concurrent requests
through the micro-batcher. Each path (flip off, flip on, batcher) zeroes
the kernels' launch counts before it runs and reads them after; each must
have launched both kernels. The kernels are timed on the inputs the
flip-off path gives them. Prints the card, the build, each phase, one
`{"kernels": [...]}` line, and as its last line
`{"ok": true, "device": {...}}`. Any failed phase exits non-zero before the
last line. Needs a CUDA device; never touches JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np

PEAK_FP32_FLOPS = 67e12        # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12           # H100 SXM HBM3
N_IMG, LONG_EDGE, TOPK = 8, 640, 32
STRIDE, J, L = 4, 17, 19


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


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #

def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f'nvidia-smi: {out.stderr.strip()}')
    return out.stdout.strip().splitlines()[0]


def phase_build():
    from offsetguided_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    _build.build_all()
    log(f'[build] {len(_build.SOURCES)} kernels in '
        f'{time.perf_counter() - t0:.1f} s (parallel nvcc, sm_90a)')
    for name in _build.SOURCES:
        lines = [ln.strip() for ln in _build.build_logs.get(name, '').splitlines()
                 if 'registers' in ln or 'spill' in ln]
        for ln in lines:
            log(f'[build] {name}: {ln}')


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


def phase_grouping(dev, skeleton, records):
    import torch
    from offsetguided_tpu_torch.config.defaults import DecoderConfig
    from offsetguided_tpu_torch.decoder import PostProcessor
    from offsetguided_tpu_torch.ops import grouping as plain
    from offsetguided_tpu_torch.ops.cuda import grouping

    cfg = DecoderConfig(topk=TOPK, thre_hmp=0.04, dist_max=40.0)
    h = LONG_EDGE // STRIDE
    maps = person_maps(N_IMG, h, h, skeleton, seed=2)
    preds = {k: [torch.from_numpy(v).to(dev)] for k, v in maps.items()}
    pp = PostProcessor(cfg=cfg)
    packed = pp.decode_packed_limbs(preds).contiguous()
    if tuple(packed.shape) != (N_IMG, L, TOPK, 13):
        fail(f'packed limbs shape {tuple(packed.shape)}')
    worst = 0.0
    for kind, x in (('persons', packed), ('sentinels', with_sentinels(packed))):
        p, s, c = grouping.group_skeletons(x, skeleton, cfg)
        rp, rs, rc = plain.group_skeletons(x, skeleton, cfg)
        torch.cuda.synchronize()
        if not torch.equal(c, rc):
            fail(f'grouping counts differ on {kind}: {c.tolist()} vs '
                 f'{rc.tolist()}')
        err = max(float((p - rp).abs().max()), float((s - rs).abs().max()))
        if not err <= 1e-4:
            fail(f'grouping poses differ on {kind} by {err}')
        worst = max(worst, err)
        log(f'[grouping] {kind}: counts {c.tolist()} identical, '
            f'max_abs_err={err:.3g}')
    ms = cuda_time(lambda: grouping.group_skeletons(packed, skeleton, cfg), 20)
    records['grouping'] = dict(
        name='group_skeletons', route='cuda',
        source='offsetguided_tpu_torch/csrc/grouping.cu',
        replaces='offsetguided_tpu/ops/pallas/grouping_pallas.py:476',
        max_abs_err=worst, ms_person_scenes=ms)
    log(f'[grouping] ({N_IMG}, {L}, {TOPK}, 13) 1-5 person scenes: kernel '
        f'{ms:.4f} ms')


def reset_launches():
    from offsetguided_tpu_torch.ops.cuda import grouping, peaks
    peaks.peaks_topk.launches = 0
    grouping.group_skeletons.launches = 0


def read_launches() -> dict:
    from offsetguided_tpu_torch.ops.cuda import grouping, peaks
    return {'peaks': peaks.peaks_topk.launches,
            'grouping': grouping.group_skeletons.launches}


def phase_full_width(dev):
    """The main path: full-width Hourglass-104 serving at 640^2, batch 8,
    flip-test off and on, each path with its own launch counts (zeroed
    just before its 2 warm-up + 5 timed batches, read just after).
    Returns ({path: {kernel: launches}}, serve, images)."""
    import torch
    from offsetguided_tpu_torch.cli.serve import ServeConfig, build_infer
    from offsetguided_tpu_torch.eval.harness import make_infer_fn
    from offsetguided_tpu_torch.models import count_params

    rng = np.random.RandomState(7)
    images = torch.from_numpy(rng.randint(
        0, 256, (N_IMG, LONG_EDGE, LONG_EDGE, 3), dtype=np.uint8)).to(dev)
    serve = build_infer(ServeConfig(flip_test=False), device=dev, seed=0)
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
        for name, n in launches[path].items():
            if n == 0:
                fail(f'the {path} path never launched the {name} kernel')
        if int(counts.sum()) == 0:
            fail(f'no poses on the {path} path: grouping did no work')
    phase_profile(infers[False], images)
    return launches, serve, images


def phase_profile(infer, images):
    """Device time of one flip-off batch by kernel, from torch.profiler:
    categories, the two CUDA kernels, and the device's idle share."""
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
        if 'peaks_' in low or 'group_kernel' in low:
            cat = 'CUDA kernels of the port'
        elif any(t in low for t in ('conv', 'gemm', 'xmma', 'cudnn', 'sm90',
                                    'cutlass', 'implicit', 'wgrad', 'dgrad')):
            cat = 'convolution / matmul'
        else:
            cat = 'other (decode glue, elementwise, copies)'
        cats[cat] = cats.get(cat, 0.0) + ms
    busy = sum(cats.values())
    log(f'[profile] one flip-off batch: wall {wall_ms:.2f} ms (profiler on), '
        f'device busy {busy:.2f} ms, idle share {1 - busy / wall_ms:.3f}')
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        log(f'[profile]   {cat}: {ms:.3f} ms ({ms / busy:.1%} of busy)')
    for name, ms, n in sorted(kernels, key=lambda r: -r[1])[:10]:
        log(f'[profile]   {ms:8.3f} ms  x{n:<4d} {name[:90]}')
    for name, ms, n in kernels:
        if 'peaks_' in name or 'group_kernel' in name:
            log(f'[profile]   port kernel {name[:60]}: {ms:.4f} ms x{n}')


def phase_main_path_kernels(skeleton, serve, images, records):
    """Both kernels on the inputs the flip-off main path gives them (the
    full-width model's heatmaps, and the packed limbs decoded from them):
    held against their plain versions, and timed with the plain versions
    and, for peaks, the library chain. These launches are not counted."""
    import torch
    import torch.nn.functional as F
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

    def library():
        up = F.interpolate(maps[:, None], scale_factor=STRIDE, mode='bicubic',
                           align_corners=False)
        hmax = F.max_pool2d(F.pad(up, (1, 1, 1, 1)), 3, stride=1)
        nms = torch.where(hmax == up, up, torch.zeros_like(up))
        return torch.topk(nms.reshape(b, -1), TOPK)

    ms = cuda_time(lambda: peaks.peaks_topk(maps, TOPK), 20)
    plain_ms = cuda_time(lambda: peaks.peaks_topk_plain(maps, TOPK), 5)
    lib_ms = cuda_time(library, 10)
    H, W = h * STRIDE, w * STRIDE
    n_bytes = maps.numel() * 4 + b * TOPK * 12
    # per map: H pass 7 ops (4 mul + 3 add) per (full-res row, source col),
    # W pass 7 per pixel, 3x3 NMS 9 per pixel, block max + selection 4 per
    # 2x2 block
    n_ops = b * (7 * H * w + 16 * H * W + 4 * (H // 2) * (W // 2))
    records['peaks'].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound=(n_bytes, n_ops))
    log(f'[main-path kernels] peaks ({b}, {h}, {w}) k={TOPK}: identical to '
        f'plain; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
        f'interpolate+max_pool+topk {lib_ms:.4f} ms')

    p, s, cnt = grouping.group_skeletons(packed, skeleton, cfg)
    rp, rs, rc = plain.group_skeletons(packed, skeleton, cfg)
    if not torch.equal(cnt, rc):
        fail(f'grouping counts differ on the main path: {cnt.tolist()} vs '
             f'{rc.tolist()}')
    err = max(float((p - rp).abs().max()), float((s - rs).abs().max()))
    if not err <= 1e-4:
        fail(f'grouping poses differ on the main path by {err}')
    r = records['grouping']
    r['max_abs_err'] = max(r['max_abs_err'], err)
    ms = cuda_time(lambda: grouping.group_skeletons(packed, skeleton, cfg), 20)
    plain_ms = cuda_time(
        lambda: plain.group_skeletons(packed, skeleton, cfg), 3, warmup=1)
    M, MP = cfg.capacity, cfg.max_poses
    n_bytes = packed.numel() * 4 + N_IMG * MP * (J * 6 + 1) * 4 + N_IMG * 4
    # per image and pass: dedup K^2, row matching 4MK, merge detection
    # M^2 J / 2 compares; 19 limb passes + settle merge passes
    passes = L + cfg.settle_passes
    n_ops = N_IMG * passes * (TOPK ** 2 + 4 * M * TOPK + M * M * J // 2)
    r.update(ms=ms, plain_ms=plain_ms, library_ms=None, bound=(n_bytes, n_ops))
    log(f'[main-path kernels] grouping {tuple(packed.shape)}: counts '
        f'{cnt.tolist()} identical, max_abs_err={err:.3g}; kernel '
        f'{ms:.4f} ms, plain {plain_ms:.4f} ms')


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
    if not all(launches.values()):
        fail(f'the batcher bypassed a kernel: launches {launches}')
    m = batcher.metrics()
    log(f'[batcher] {len(shapes)} concurrent requests of mixed sizes: all '
        f'answered, poses per request {[len(r) for r in results]}, '
        f'p50 latency {np.median(lat) * 1e3:.1f} ms (host preprocess + '
        f'queue + batch), device-batch p50 '
        f'{m["device_batch_p50_ms"]:.1f} ms over {m["batches"]} '
        f'batches, kernel launches {launches}')
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        fail('torch is not installed')
    if not torch.cuda.is_available():
        fail('no CUDA device: this smoke run needs the card')
    dev = torch.device('cuda', 0)
    log(card_line())
    log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}')

    from offsetguided_tpu_torch.config import COCO_PERSON_SKELETON
    skeleton = tuple(COCO_PERSON_SKELETON)
    records = {}
    phase_build()
    phase_peaks(dev, skeleton, records)
    phase_grouping(dev, skeleton, records)
    launches, serve, images = phase_full_width(dev)
    phase_main_path_kernels(skeleton, serve, images, records)
    phase_reference(dev, serve)
    launches['batcher'] = phase_batcher(dev, serve)

    kernels = []
    for key in ('peaks', 'grouping'):
        r = records[key]
        n_bytes, n_ops = r.pop('bound')
        t_bytes = n_bytes / PEAK_BYTES * 1e3
        t_ops = n_ops / PEAK_FP32_FLOPS * 1e3
        by_path = {path: n[key] for path, n in launches.items()}
        kernels.append(dict(
            r, launches=by_path['flip_off'] + by_path['flip_on'],
            launches_by_path=by_path, bound_ms=max(t_bytes, t_ops),
            bound_by='bytes' if t_bytes >= t_ops else 'operations'))
    log(card_line())
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
