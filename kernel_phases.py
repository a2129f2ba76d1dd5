#!/usr/bin/env python3
"""Phase split of the port's kernels on one NVIDIA card.

    python3 kernel_phases.py [--csrc DIR] [--baseline DIR]
                             [--kernels peaks,topk,grouping,nms_topk]
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
NMS + top-k runs on the stride-resolution route's (136, 160, 160) maps (the
full-width model's heatmaps, seeded as above), person scenes and random^4,
at k=32: a two-launch source (the kernel's first design) also as a
`no_select` cut of its tile selection, a source with `OG_PHASE` markers
also as a `phased` copy (cycles per map, summed over its CTAs); with
`--baseline DIR` the baseline's `nms_topk.cu` (through its own C
interface) and this one in turns. Each call is checked against the plain
version; the lines give CUDA-event ms per call, device ms per launch and
their difference (the wrapper's host time the card waits for), and the
time of the route's copy of the heatmaps into (N*C, h, w) maps; then the
stride-resolution decode end to end (one batch's decode, and forward +
decode).
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
SELECT_TILE = re.compile(r'og::select_smallest\((\w+),[^;]*?,\s*([^,;]+)\);')
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


def phased(src: str, what: str = 'grouping'):
    """(copy of a kernel source that times its phases, phase names in
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
        raise SystemExit(f'{what} source: no shared-memory declaration to '
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
            phased(src)[0]
    return out


# nms_topk: a two-launch source (the kernel's first design) has a
# tile selection to cut; its merge then reads unselected keys, so the cut
# copy also clamps the index the merge gathers at into the map
MERGE_INDEX = re.compile(r'\(int\)og::key_index\(best\[r\]\)')
# that source's C interface: a tile count, and a candidate buffer per call
# (kept only so that PERF.md's comparison with the two-launch tree can be
# run again; a baseline with the one-launch interface needs none of it)
TWO_LAUNCH_NMS = {
    'og_nms_topk_tiles': ([ctypes.c_int, ctypes.c_int], ctypes.c_int),
    'og_nms_topk': ([ctypes.c_void_p] + [ctypes.c_int] * 4
                    + [ctypes.c_void_p] * 4, ctypes.c_int),
}


def cut_nms_select(src: str) -> str:
    head, sep, rest = src.partition('#include "topk_select.cuh"\n')
    src = cut_select(head + sep + SINK + rest)
    if not MERGE_INDEX.search(src):
        raise SystemExit('no merge index found to clamp in nms_topk.cu')
    return MERGE_INDEX.sub(
        '(int)(og::key_index(best[r]) % (uint32_t)(h * w))', src, 1)


# one-launch nms_topk (the cluster design): cuts of one phase each, as
# (text, the text in its place); a cut copy gives wrong answers and is only
# timed
NMS_CUTS = {
    # no band selection: a band passes on its first keys
    'no_band_select': [('if (n > k && !(k <= SMALL_K && n <= 64)) {',
                        'if (false) {')],
    # staging only: no NMS pass, no zero fill (bands pass on KEY_NONE)
    'load_only': [('  const int strips = (rows + STRIP - 1) / STRIP * cols;',
                   '  const int strips = 0;'),
                  ('  } else if (n < want) {', '  } else if (false) {')],
    # no leader merge: every CTA ends after the cluster barrier
    'no_merge': [('    if (band != 0 || warp != 0) return;', '    return;')],
}


# ... and other settings of the same design, right answers, timed in turns
# with the source: the registers capped for 8 CTAs an SM, or for 4 (the
# source caps them for 6: the kernel is bound by latency, not issue); the
# radix select for every k, without the warp sort and merges of k <= 32
NMS_SETTINGS = {
    'min_blocks_8': [('__launch_bounds__(THREADS, 6)',
                      '__launch_bounds__(THREADS, 8)')],
    'min_blocks_4': [('__launch_bounds__(THREADS, 6)',
                      '__launch_bounds__(THREADS, 4)')],
    'radix_only': [('constexpr int SMALL_K = 32;',
                    'constexpr int SMALL_K = 0;')],
}


def cut_text(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f'nms_topk.cu: no anchor {old[:40]!r} to cut')
        src = src.replace(old, new, 1)
    return src


def nms_topk_variants(csrc: Path, baseline=None):
    """{('nms_topk', variant): source}: this tree's `full`, the baseline's
    `baseline` where given, and for each a `no_select` cut (a two-launch
    source) or a `phased` copy (a source with `OG_PHASE` markers), named
    with the tree's prefix."""
    out = {}
    for prefix, d in (('', csrc), ('baseline', baseline)):
        if d is None:
            continue
        src = (d / 'nms_topk.cu').read_text()
        out['nms_topk', prefix or 'full'] = src
        if SELECT.search(src):
            out['nms_topk', f'{prefix}_no_select'.lstrip('_')] = \
                cut_nms_select(src)
        if MARKER.search(src):
            out['nms_topk', f'{prefix}_phased'.lstrip('_')] = \
                phased(src, 'nms_topk')[0]
            for cut, edits in {**NMS_CUTS, **NMS_SETTINGS}.items():
                out['nms_topk', f'{prefix}_{cut}'.lstrip('_')] = \
                    cut_text(src, edits)
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
        sigs = _build.SIGNATURES[name]
        if hasattr(lib, 'og_nms_topk_tiles'):
            sigs = TWO_LAUNCH_NMS
        # an older source may lack a newer entry point
        for fn, (args, res) in {**sigs, **phase_fns}.items():
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
    from offsetguided_tpu_torch.cli.serve import build_infer, cli
    from offsetguided_tpu_torch.config import COCO_PERSON_SKELETON
    from offsetguided_tpu_torch.ops.image import normalize_images

    infer, _, _, model = build_infer(cli([]), device=dev, seed=0)
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
    names = {'phased': phased((csrc / 'grouping.cu').read_text())[1]}
    srcs = {'full': (csrc / 'grouping.cu').read_text()}
    if baseline is not None:
        srcs['baseline'] = (baseline / 'grouping.cu').read_text()
        names['baseline_phased'] = phased(srcs['baseline'])[1]
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


def nms_call(lib, k: int):
    """maps -> (vals, inds) through `lib` as its own tree's wrapper calls
    it: the two-launch interface (a tile-count query and a candidate buffer
    per call, int32 indices widened after), or this tree's wrapper."""
    import torch
    from offsetguided_tpu_torch.ops.cuda import _build, nms_topk
    if not hasattr(lib, 'og_nms_topk_tiles'):
        return lambda x: nms_topk.nms_topk(x, k)

    def call(x):
        m, h, w = x.shape
        cand = torch.empty(m * lib.og_nms_topk_tiles(h, w) * k,
                           dtype=torch.int64, device=x.device)
        vals = torch.empty((m, k), dtype=torch.float32, device=x.device)
        inds = torch.empty((m, k), dtype=torch.int32, device=x.device)
        with torch.cuda.device(x.device):
            code = lib.og_nms_topk(
                x.data_ptr(), m, h, w, k, cand.data_ptr(), vals.data_ptr(),
                inds.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(code, 'nms_topk kernel launch')
        return vals, inds.long()
    return call


def nms_inputs(dev):
    """({name: (M, h, w) maps}, the model's (8, 160, 160, 17) heatmaps as
    the head returns them, and a stride-resolution decode of the model's
    batch): the route's maps (the full-width model, seeded weights and
    images as `chip_smoke.py` serves them), person scenes and random^4."""
    import dataclasses

    import numpy as np
    import torch
    from chip_smoke import LONG_EDGE, person_maps
    from offsetguided_tpu_torch.cli.serve import build_infer, cli
    from offsetguided_tpu_torch.config import COCO_PERSON_SKELETON
    from offsetguided_tpu_torch.decoder.pipeline import PostProcessor
    from offsetguided_tpu_torch.ops.image import normalize_images

    infer, _, _, model = build_infer(cli([]), device=dev, seed=0)
    pp = PostProcessor(cfg=dataclasses.replace(infer.postprocessor.cfg,
                                               upsampled_decode=False))
    images = torch.from_numpy(np.random.RandomState(7).randint(
        0, 256, (N_IMG, LONG_EDGE, LONG_EDGE, 3), dtype=np.uint8)).to(dev)
    with torch.inference_mode():
        x = normalize_images(images)
        preds = model(x)
    hmp = preds['hmp'][-1]
    routes = {'decode': lambda: pp.decode_body(preds),
              'forward_decode': lambda: pp.decode_body(model(x))}
    n, h, w, c = hmp.shape
    persons = person_maps(N_IMG, h, w, tuple(COCO_PERSON_SKELETON), seed=2)
    pow4 = np.random.RandomState(9).rand(n * c, h, w).astype(np.float32) ** 4
    return {'model': hmp.permute(0, 3, 1, 2).reshape(n * c, h, w).contiguous(),
            'persons': torch.from_numpy(np.ascontiguousarray(
                persons['hmp'].transpose(0, 3, 1, 2)).reshape(n * c, h, w)
            ).to(dev),
            'pow4': torch.from_numpy(pow4).to(dev)}, hmp, routes


def device_busy(fn, iters: int = 10) -> float:
    """Device milliseconds per call of `fn`, summed over every kernel it
    launches, by torch.profiler (0.0 where it recorded none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / iters


def lowres_route(routes):
    """The stride-resolution decode end to end, as `ops/decoder.py` runs it
    (the head's channel slice copied into (N*C, h, w) maps, then the
    kernel): one batch's decode (`PostProcessor.decode_body`) and the
    eval's batch (forward + decode), twice each; CUDA events over the calls,
    the host clock per call (median) and the device time per call."""
    import statistics
    import time

    import torch
    from chip_smoke import cuda_time
    results = []
    with torch.inference_mode():
        for what, fn in routes.items():
            iters = 20 if what == 'decode' else 10
            for turn in range(2):
                ms = cuda_time(fn, iters, warmup=2)
                wall = []
                for _ in range(iters):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    wall.append((time.perf_counter() - t0) * 1e3)
                busy = device_busy(fn, iters)
                results.append(dict(
                    kernel='nms_topk', input='lowres_route', route=what,
                    turn=turn, ms=ms, wall_ms=statistics.median(wall),
                    device_ms=busy))
                print(f'[nms_topk] lowres {what}: {ms:.4f} ms by events, '
                      f'host clock {statistics.median(wall):.4f} ms, device '
                      f'{busy:.4f} ms', flush=True)
    return results


def run_nms_topk(libs, dev, csrc: Path, baseline):
    """Each nms_topk copy in turns with its tree's full source on the same
    maps (the baseline first where given: baseline, full, full, baseline),
    each checked against the plain version; CUDA-event ms per call, device
    ms per launch, their difference (the wrapper's host time the card waits
    for), and the phased copies' cycles per map; and the route's copy of
    the heatmaps into (M, h, w) maps."""
    import torch
    from chip_smoke import bits, cuda_time, launch_split
    from offsetguided_tpu_torch.ops.cuda import _build, nms_topk
    data, hmp, routes = nms_inputs(dev)
    n, h, w, c = hmp.shape
    with torch.inference_mode():
        copy_ms = cuda_time(lambda: hmp.permute(0, 3, 1, 2).reshape(
            n * c, h, w), 20, warmup=3)
    results = [dict(kernel='nms_topk', input='model', variant='route_copy',
                    shape=list(hmp.shape), stride=list(hmp.stride()),
                    ms=copy_ms)]
    print(f'[nms_topk] the route\'s (N*C, h, w) copy of the heatmaps '
          f'{tuple(hmp.shape)} stride {hmp.stride()}: {copy_ms:.4f} ms',
          flush=True)
    names = {v: phased((csrc if not v.startswith('baseline')
                        else baseline).joinpath('nms_topk.cu').read_text(),
                       'nms_topk')[1]
             for (k_, v) in libs if k_ == 'nms_topk' and v.endswith('phased')}
    pairs = []
    if baseline is not None:
        pairs.append(('baseline', 'full'))
    cuts = ('no_select',) + tuple(NMS_CUTS)
    for (k_, v) in libs:
        if k_ == 'nms_topk' and v.endswith(cuts + tuple(NMS_SETTINGS)):
            pairs.append((v, 'baseline' if v.startswith('baseline')
                          else 'full'))
    parts = ('tile', 'merge', 'nms_topk')
    for kind, x in data.items():
        want = nms_topk.nms_topk_plain(x, K)
        for var, ref in pairs:
            for turn in (ref, var, var, ref):
                lib = libs['nms_topk', turn]
                _build._libs['nms_topk'] = lib
                fn = partial(nms_call(lib, K), x)
                if not turn.endswith(cuts):
                    v, i = fn()
                    if not (torch.equal(i, want[1])
                            and torch.equal(bits(v), bits(want[0]))):
                        raise SystemExit(f'nms_topk {turn} differs from plain '
                                         f'on {kind}')
                total = cuda_time(fn, 20, warmup=3)
                split = launch_split(fn, parts=parts)
                dev_ms = [t for t in split.values() if t is not None]
                device = sum(dev_ms) if dev_ms else None
                results.append(dict(
                    kernel='nms_topk', input=kind, shape=list(x.shape),
                    variant=turn, ms=total, device_ms=device,
                    host_wait_ms=None if device is None else total - device,
                    **split))
                print(f'[nms_topk] {kind} {tuple(x.shape)} k={K} {turn}: '
                      f'{total:.4f} ms; device ' + (
                          'not measured' if device is None else
                          f'{device:.4f} ms (' + ', '.join(
                              f'{p[:-3]} {t:.4f}' for p, t in split.items()
                              if t is not None) + ')'), flush=True)
        for var, phase_names in names.items():
            lib = libs['nms_topk', var]
            _build._libs['nms_topk'] = lib
            fn = partial(nms_call(lib, K), x)
            ms = cuda_time(fn, 20, warmup=3)
            khz, phases = grouping_phases(lib, fn, x.shape[0], phase_names)
            results.append(dict(kernel='nms_topk', input=kind,
                                shape=list(x.shape), variant=var, ms=ms,
                                clock_khz=khz, phases=phases))
            print(f'[nms_topk] {kind} {var}: {ms:.4f} ms with the stamps; per '
                  f'map, summed over its CTAs, at {khz / 1e3:.0f} MHz:',
                  flush=True)
            for p in phases:
                print(f'[nms_topk]   {p["phase"]:>12}: {p["cycles"]:10.0f} '
                      f'cycles {p["us"]:9.3f} us over {p["passes"]:.0f} '
                      f'stamps', flush=True)
    _build._libs['nms_topk'] = libs['nms_topk', 'full']
    return results + lowres_route(routes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--csrc', type=Path,
                    default=ROOT / 'offsetguided_tpu_torch' / 'csrc')
    ap.add_argument('--baseline', type=Path, default=None,
                    help='an older csrc/ whose grouping.cu and nms_topk.cu '
                         'are timed in turns with this one')
    ap.add_argument('--kernels', default='peaks,topk,grouping,nms_topk')
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
    if 'nms_topk' in kernels:
        sources.update(nms_topk_variants(args.csrc, args.baseline))
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
    if 'nms_topk' in kernels:
        results += run_nms_topk(libs, dev, args.csrc, args.baseline)
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
