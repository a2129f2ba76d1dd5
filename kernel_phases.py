#!/usr/bin/env python3
"""Phase split of the selection kernels on one NVIDIA card.

    python3 kernel_phases.py [--csrc DIR] [--out build/phases/kernel_phases.json]

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


def build(csrc: Path, build_dir: Path):
    from chip_smoke import ptxas_lines
    from offsetguided_tpu_torch.ops.cuda import _build
    build_dir.mkdir(parents=True, exist_ok=True)
    for h in csrc.glob('*.cuh'):
        (build_dir / h.name).write_bytes(h.read_bytes())
    jobs = {}
    for (name, var), src in variants(csrc).items():
        cu = build_dir / f'{name}_{var}.cu'
        cu.write_text(src)
        so = build_dir / f'lib{name}_{var}.so'
        jobs[name, var] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, '-o', str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for (name, var), (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f'nvcc failed for {name}_{var}:\n{log}')
        for ln in ptxas_lines(log):
            print(f'[ptxas] {name}_{var}: {ln}', flush=True)
        lib = ctypes.CDLL(str(so))
        for fn, (args, res) in _build.SIGNATURES[name].items():
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--csrc', type=Path,
                    default=ROOT / 'offsetguided_tpu_torch' / 'csrc')
    ap.add_argument('--out', type=Path,
                    default=ROOT / 'build' / 'phases' / 'kernel_phases.json')
    args = ap.parse_args(argv)
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
    libs = build(args.csrc, ROOT / 'build' / 'phases')
    data = inputs(dev)
    calls = {'peaks': lambda x: peaks.peaks_topk(x, K),
             'topk': lambda x: topk.topk(x, K)}
    results = []
    for name in ('peaks', 'topk'):
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
    _build._libs.clear()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({'card': card, 'csrc': str(args.csrc),
                                    'results': results}, indent=1))
    print(card, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
