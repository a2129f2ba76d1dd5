#!/usr/bin/env python3
"""Phase split of the port's kernels on one NVIDIA card.

    python3 kernel_phases.py [--csrc DIR] [--baseline DIR]
                             [--kernels peaks,topk,grouping]
                             [--out build/phases/kernel_phases.json]

Builds copies of `csrc/peaks.cu` and `csrc/topk.cu` (or of the sources in
DIR, e.g. an older checkout) with a phase cut out, and times each copy
beside the unchanged source, in turns (full, cut, cut, full), on the same
inputs: `peaks` on (136, 160, 160) person-scene and random^4 heatmaps,
`topk` on (136, 320x512) block maxima of NMS'd x4 person-scene heatmaps,
both at k=32. Variants:
- `full`: the source as it is;
- `no_select`: the tile kernel's selection replaced by a sink that reads
  every key (so the work before it stays) and stores nothing;
- `peaks` only, `no_nms`: also the NMS + block max replaced by a sink over
  the upsampled tile (upsample alone);
- `topk` selecting over a row tile (`og::select_smallest`) only,
  `tile_2048` / `tile_4096` / `tile_8192`: another tile size.
Grouping, whose later phases need the earlier ones' state, is split by
time instead: a copy of `csrc/grouping.cu` in which each `OG_PHASE(name)`
marker (or, in a source without markers, each `__syncthreads()`, named by
its line) adds thread 0's `clock64()` cycles since the last marker to a
per-phase device counter, summed over the CTAs. It runs on the serving
path's packed limbs (8, 19, 32, 13) at capacity 64 (the full-width model,
seeded weights and images as `chip_smoke.py` serves them), the 1-5-person
scenes, and a capacity-128 crowd at top-k 96; each phase is reported in
cycles and microseconds per image, summed over the passes. `--baseline DIR`
adds an older `grouping.cu` (e.g. the parent checkout's `csrc/`), timed in
turns with this one (baseline, full, full, baseline) and split the same
way, on the inputs at capacity 64 only.
The copies live under `build/phases/` (git-ignored) and are never part of
the package. Tile and merge launch times come from torch.profiler, the
total from CUDA events (`chip_smoke.py`'s helpers). Prints the card, each
copy's ptxas report, one line per (kernel, variant), and writes the
numbers as JSON to `--out`.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent
K, N_IMG, J = 32, 8, 17

SINK = r'''
namespace {
// Reads n keys of shared memory and stores only on a value no key takes,
// so the work that produced the keys is kept and nothing is selected.
__device__ __forceinline__ void og_phase_sink(const unsigned long long* keys,
                                              int n, unsigned long long* dst) {
  unsigned long long x = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) x ^= keys[i];
  if (x == 0x5a5a5a5a5a5a5a5aull) dst[threadIdx.x] = x;
}
__device__ __forceinline__ void og_phase_sink_f(const float* v, int n,
                                                unsigned long long* dst) {
  float x = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) x += v[i];
  if (x == 1234.5f) dst[threadIdx.x] = 1;
}
}  // namespace
'''
# the tile kernels' selection call: og::block_select(keys, n_per_warp, k,
# scratch, dst) over shared memory (peaks.cu, and topk.cu's first design);
# og::select_smallest(tile, k, win, dst) over a row tile (topk.cu)
SELECT = re.compile(
    r'og::block_select\(([^,]+),([^,]+),[^,]+,[^,]+,([^;]+)\);')
SELECT_TILE = re.compile(r'og::select_smallest\((\w+),[^;]*?(cand \+[^;]+)\);')
TILE = re.compile(r'constexpr int TILE = \d+;')
# peaks: from the NMS loop's comment up to the selection
NMS = re.compile(r'(  // NMS \+ 2x2 block max.*?\n)(.*?)(\n  // top-k)', re.S)


def cut_select(src: str) -> str:
    if SELECT.search(src):
        return SELECT.sub(
            r'og_phase_sink(\1, (\2) * (int)(blockDim.x / 32), \3);', src, 1)
    m = SELECT_TILE.search(src)
    if not m:
        raise SystemExit('no selection call found to cut')
    return src[:m.start()] + (
        f'{{ uint32_t x_ = 0;\n#pragma unroll\n  for (int q = 0; q < PER; ++q) '
        f'x_ ^= {m[1]}.hi(q);\n  '
        f'if (x_ == 0x5a5a5a5au) ({m[2]})[threadIdx.x] = x_; }}'
    ) + src[m.end():]


def cut_nms(src: str) -> str:
    m = NMS.search(src)
    if not m:
        raise SystemExit('no NMS block found to cut in peaks.cu')
    tail = src[m.end(3):]
    end = tail.index('\n}\n')
    return (src[:m.start(2)]
            + '  og_phase_sink_f(&up[0][0], UP * UP, cand);\n}\n'
            + tail[end + 3:])


def variants(csrc: Path):
    out = {}
    for name in ('peaks', 'topk'):
        src = (csrc / f'{name}.cu').read_text()
        head, sep, rest = src.partition('#include "topk_select.cuh"\n')
        src = head + sep + SINK + rest
        out[(name, 'full')] = src
        out[(name, 'no_select')] = cut_select(src)
        if name == 'peaks':
            out[(name, 'no_nms')] = cut_nms(src)
        elif SELECT_TILE.search(src):   # row tiles: other tile sizes
            cur = TILE.search(src)[0]
            for tile in (2048, 4096, 8192):
                if f' {tile};' not in cur:
                    out[(name, f'tile_{tile}')] = src.replace(
                        cur, f'constexpr int TILE = {tile};', 1)
    return out


# grouping: a clock64() stamp by thread 0 at each phase marker, summed per
# phase over the CTAs into a device counter
PHASE_HEAD = r'''#include <cuda_runtime.h>
__device__ unsigned long long og_phase_cycles[64];
__device__ unsigned long long og_phase_hits[64];
__shared__ long long og_phase_last;
__device__ __forceinline__ void og_phase_begin() {
  if (threadIdx.x == 0) og_phase_last = clock64();
}
__device__ __forceinline__ void og_phase_stamp(int id) {
  if (threadIdx.x == 0) {
    const long long now = clock64();
    atomicAdd(&og_phase_cycles[id], (unsigned long long)(now - og_phase_last));
    atomicAdd(&og_phase_hits[id], 1ull);
    og_phase_last = now;
  }
}
extern "C" int og_phase_read(unsigned long long* cycles,
                             unsigned long long* hits) {
  cudaError_t e = cudaMemcpyFromSymbol(cycles, og_phase_cycles,
                                       sizeof og_phase_cycles);
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(hits, og_phase_hits, sizeof og_phase_hits);
  return (int)e;
}
extern "C" int og_phase_reset() {
  static const unsigned long long zero[64] = {};
  cudaError_t e = cudaMemcpyToSymbol(og_phase_cycles, zero, sizeof zero);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(og_phase_hits, zero, sizeof zero);
  return (int)e;
}
extern "C" int og_phase_clock_khz() {
  int dev = 0, khz = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, dev);
  return khz;
}
#define OG_PHASE(name) og_phase_stamp(OG_PHASE_##name)
'''
MARKER = re.compile(r'^[ \t]*OG_PHASE\((\w+)\);', re.M)
SHARED_DECL = re.compile(r'extern __shared__[^;]*;')


def phased_grouping(src: str):
    """(copy of a grouping source that times its phases, phase names in
    counter order). A source without `OG_PHASE` markers gets one after each
    `__syncthreads()`, named by that line's number."""
    if not MARKER.search(src):
        lines = src.split('\n')
        for i, ln in enumerate(lines):
            if '__syncthreads();' in ln:
                indent = ln[:len(ln) - len(ln.lstrip())]
                lines[i] = f'{ln}\n{indent}OG_PHASE(line{i + 1});'
        src = '\n'.join(lines)
    names = list(dict.fromkeys(MARKER.findall(src)))
    if not SHARED_DECL.search(src) or len(names) > 64:
        raise SystemExit('grouping source: no shared-memory declaration to '
                         'start the clock at, or too many phases')
    src = SHARED_DECL.sub(lambda m: m[0] + ' og_phase_begin();', src, 1)
    enum = 'enum { ' + ', '.join(f'OG_PHASE_{n} = {i}'
                                 for i, n in enumerate(names)) + ' };\n'
    return PHASE_HEAD + enum + src, names


def grouping_variants(csrc: Path, baseline=None):
    """{('grouping', variant): source}: this tree's `full` and `phased`,
    and the baseline's `baseline` and `baseline_phased` where given."""
    out = {}
    for prefix, d in (('', csrc), ('baseline', baseline)):
        if d is None:
            continue
        src = (d / 'grouping.cu').read_text()
        out['grouping', prefix or 'full'] = src
        out['grouping', f'{prefix}_phased'.lstrip('_')] = \
            phased_grouping(src)[0]
    return out


def build(sources: dict, csrc: Path, build_dir: Path):
    from chip_smoke import ptxas_lines
    from offsetguided_tpu_torch.ops.cuda import _build
    build_dir.mkdir(parents=True, exist_ok=True)
    for h in csrc.glob('*.cuh'):
        (build_dir / h.name).write_bytes(h.read_bytes())
    jobs = {}
    for (name, var), src in sources.items():
        cu = build_dir / f'{name}_{var}.cu'
        cu.write_text(src)
        so = build_dir / f'lib{name}_{var}.so'
        jobs[name, var] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, '-o', str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    phase_fns = {'og_phase_read': ([ctypes.c_void_p, ctypes.c_void_p],
                                   ctypes.c_int),
                 'og_phase_reset': ([], ctypes.c_int),
                 'og_phase_clock_khz': ([], ctypes.c_int)}
    for (name, var), (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f'nvcc failed for {name}_{var}:\n{log}')
        for ln in ptxas_lines(log):
            print(f'[ptxas] {name}_{var}: {ln}', flush=True)
        lib = ctypes.CDLL(str(so))
        # an older source may lack a newer entry point
        for fn, (args, res) in {**_build.SIGNATURES[name], **phase_fns}.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = res
        libs[name, var] = lib
    return libs


def inputs(dev):
    import torch
    import torch.nn.functional as F
    from chip_smoke import peak_inputs, person_maps
    from offsetguided_tpu_torch.config import COCO_PERSON_SKELETON
    from offsetguided_tpu_torch.ops.decoder import hmp_nms
    from offsetguided_tpu_torch.ops.resize import upsample2d

    sk = tuple(COCO_PERSON_SKELETON)
    pk = peak_inputs(N_IMG * J, 160, 160, sk)
    hmp = torch.from_numpy(person_maps(N_IMG, 160, 256, sk, seed=5)['hmp'])
    with torch.inference_mode():
        bm = F.max_pool2d(hmp_nms(upsample2d(hmp.to(dev), 4, 'bicubic'))
                          .permute(0, 3, 1, 2), 2, stride=2)
    return {
        'peaks': {kind: torch.from_numpy(pk[kind]).to(dev)
                  for kind in ('persons', 'pow4')},
        'topk': {'persons_blockmax': bm.reshape(N_IMG * J, -1).contiguous()},
    }


def grouping_inputs(dev):
    """{name: (packed limbs, DecoderConfig)}: the serving path's limbs (the
    full-width model with seeded weights on `chip_smoke.py`'s seeded
    640x640 batch), the 1-5-person scenes of `chip_smoke.py`'s
    `[grouping]`, and its capacity-128 crowd."""
    import numpy as np
    import torch
    from chip_smoke import LONG_EDGE, crowd_case, person_scene_limbs
    from offsetguided_tpu_torch.cli.serve import ServeConfig, build_infer
    from offsetguided_tpu_torch.config import COCO_PERSON_SKELETON
    from offsetguided_tpu_torch.ops.image import normalize_images

    infer, _, _, model = build_infer(ServeConfig(flip_test=False), device=dev,
                                     seed=0)
    pp = infer.postprocessor
    images = torch.from_numpy(np.random.RandomState(7).randint(
        0, 256, (N_IMG, LONG_EDGE, LONG_EDGE, 3), dtype=np.uint8)).to(dev)
    with torch.inference_mode():
        packed = pp.decode_packed_limbs(model(normalize_images(images)))
    del model
    torch.cuda.empty_cache()
    persons, cfg = person_scene_limbs(dev, tuple(COCO_PERSON_SKELETON))
    return {'main_path': (packed.contiguous(), pp.cfg),
            'persons': (persons, cfg), 'crowd_128': crowd_case(dev)}


def grouping_phases(lib, call, n_img: int, names, reps: int = 10):
    """Cycles and microseconds per image of each phase over `reps` calls of
    the phased copy `lib` (bound as the wrapper's library by the caller)."""
    import numpy as np
    import torch
    from offsetguided_tpu_torch.ops.cuda import _build
    call()
    torch.cuda.synchronize()
    _build.check(lib.og_phase_reset(), 'phase counter reset')
    for _ in range(reps):
        call()
    torch.cuda.synchronize()
    cycles = np.zeros(64, np.uint64)
    hits = np.zeros(64, np.uint64)
    _build.check(lib.og_phase_read(cycles.ctypes.data, hits.ctypes.data),
                 'phase counter read')
    khz = lib.og_phase_clock_khz()
    per = reps * n_img
    return khz, [dict(phase=n, cycles=float(cycles[i]) / per,
                      us=float(cycles[i]) / per / khz * 1e3,
                      passes=float(hits[i]) / per)
                 for i, n in enumerate(names)]


def run_grouping(libs, dev, csrc: Path, baseline):
    from chip_smoke import cuda_time, grouping_barriers, launch_split
    from offsetguided_tpu_torch.config import COCO_PERSON_SKELETON
    from offsetguided_tpu_torch.ops.cuda import _build, grouping
    sk = tuple(COCO_PERSON_SKELETON)
    names = {'phased': phased_grouping((csrc / 'grouping.cu').read_text())[1]}
    srcs = {'full': (csrc / 'grouping.cu').read_text()}
    if baseline is not None:
        srcs['baseline'] = (baseline / 'grouping.cu').read_text()
        names['baseline_phased'] = phased_grouping(srcs['baseline'])[1]
    results = []
    for kind, (x, cfg) in grouping_inputs(dev).items():
        old_too = baseline is not None and cfg.capacity <= 64
        fn = partial(grouping.group_skeletons, x, sk, cfg,
                     capacity=cfg.capacity)
        turns = ('baseline', 'full', 'full', 'baseline') if old_too else (
            'full', 'full')
        for turn in turns:
            _build._libs['grouping'] = libs['grouping', turn]
            total = cuda_time(fn, 20, warmup=3)
            dev_ms = launch_split(fn, parts=('group',))['group_ms']
            results.append(dict(kernel='grouping', input=kind,
                                shape=list(x.shape), capacity=cfg.capacity,
                                variant=turn, ms=total, group_ms=dev_ms))
            print(f'[grouping] {kind} {tuple(x.shape)} capacity '
                  f'{cfg.capacity} {turn}: {total:.4f} ms; device '
                  + ('not measured' if dev_ms is None else f'{dev_ms:.4f} ms'),
                  flush=True)
        for var in names if old_too else ('phased',):
            lib = libs['grouping', var]
            _build._libs['grouping'] = lib
            ms = cuda_time(fn, 20, warmup=3)
            khz, phases = grouping_phases(lib, fn, x.shape[0], names[var])
            src = srcs['baseline' if var.startswith('baseline') else 'full']
            barriers = grouping_barriers(src, x.shape[1], cfg.settle_passes)
            stamped = sum(p['us'] for p in phases)
            results.append(dict(kernel='grouping', input=kind,
                                shape=list(x.shape), capacity=cfg.capacity,
                                variant=var, ms=ms, clock_khz=khz,
                                barriers_per_image=barriers,
                                stamped_us_per_image=stamped, phases=phases))
            print(f'[grouping] {kind} capacity {cfg.capacity} {var}: '
                  f'{ms:.4f} ms with the stamps, {barriers} barriers per '
                  f'image; per image, summed over its passes, at '
                  f'{khz / 1e3:.0f} MHz:', flush=True)
            for p in phases:
                print(f'[grouping]   {p["phase"]:>12}: {p["cycles"]:10.0f} '
                      f'cycles {p["us"]:9.3f} us over {p["passes"]:.0f} '
                      f'passes', flush=True)
            print(f'[grouping]   {"stamped":>12}: {stamped:.3f} us',
                  flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--csrc', type=Path,
                    default=ROOT / 'offsetguided_tpu_torch' / 'csrc')
    ap.add_argument('--baseline', type=Path, default=None,
                    help='an older csrc/ whose grouping.cu is timed in turns '
                         'with this one')
    ap.add_argument('--kernels', default='peaks,topk,grouping')
    ap.add_argument('--out', type=Path,
                    default=ROOT / 'build' / 'phases' / 'kernel_phases.json')
    args = ap.parse_args(argv)
    kernels = args.kernels.split(',')
    import torch
    if not torch.cuda.is_available():
        print('FAILED: no CUDA device', file=sys.stderr)
        return 1
    from chip_smoke import cuda_time, launch_split, split_text
    from offsetguided_tpu_torch.ops.cuda import _build, peaks, topk
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device('cuda', 0)
    sources = {k: v for k, v in variants(args.csrc).items()
               if k[0] in kernels}
    if 'grouping' in kernels:
        sources.update(grouping_variants(args.csrc, args.baseline))
    libs = build(sources, args.csrc, ROOT / 'build' / 'phases')
    calls = {'peaks': lambda x: peaks.peaks_topk(x, K),
             'topk': lambda x: topk.topk(x, K)}
    results = []
    data = inputs(dev) if {'peaks', 'topk'} & set(kernels) else {}
    for name in [n for n in ('peaks', 'topk') if n in kernels]:
        vars_ = [v for (n, v) in libs if n == name and v != 'full']
        for kind, x in data[name].items():
            for var in vars_:
                for turn in ('full', var, var, 'full'):
                    _build._libs[name] = libs[name, turn]
                    fn = partial(calls[name], x)
                    total = cuda_time(fn, 20, warmup=3)
                    split = launch_split(fn)
                    results.append(dict(kernel=name, input=kind,
                                        shape=list(x.shape), variant=turn,
                                        ms=total, **split))
                    print(f'[{name}] {kind} {tuple(x.shape)} k={K} {turn}: '
                          f'{total:.4f} ms; {split_text(split)}', flush=True)
    if 'grouping' in kernels:
        results += run_grouping(libs, dev, args.csrc, args.baseline)
    _build._libs.clear()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({
        'card': card, 'csrc': str(args.csrc),
        'baseline': None if args.baseline is None else str(args.baseline),
        'results': results}, indent=1))
    print(card, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
