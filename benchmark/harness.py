"""What every cell shares: the files a cell is made of, seeds, the seeded
weights, the import guard, and the device record.

A cell is found by name: its entry of `BENCHMARK.json` names a
configuration (`configs/<config>.json`) and a traffic mix
(`traffic/<traffic>.json`); the traffic's `entry` names the runner
(`entries/<entry>.py`); each metric is read by `metrics/<metric>.py`; the
limits of the output check are `limits/<workload>.json`. Adding a cell, a
configuration, a mix or a metric adds files and entries and edits none.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'offsetguided_tpu')


def load_json(path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(bench: Dict, workload: str, root: Path = ROOT) -> Dict:
    """The cell's pieces: workload entry, config, traffic, limits."""
    wl = next((w for w in bench['workloads'] if w['name'] == workload), None)
    if wl is None:
        raise KeyError(f'no workload {workload!r} in BENCHMARK.json')
    conf = next(c for c in bench['configs'] if c['name'] == wl['config'])
    here = root / 'benchmark'
    limits = here / 'limits' / f'{workload}.json'
    return {'workload': wl,
            'config': load_json(root / conf['file']),
            'traffic': load_json(here / 'traffic' / f"{wl['traffic']}.json"),
            'limits': load_json(limits) if limits.exists() else None}


def entry(traffic: Dict, root: Path = ROOT) -> ModuleType:
    name = traffic['entry']
    return load_module(root / 'benchmark' / 'entries' / f'{name}.py',
                       f'bench_entry_{name}')


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    return load_module(root / 'benchmark' / 'metrics' / f'{name}.py',
                       'bench_metric_' + name.replace('.', '_'))


def metrics_of(bench: Dict, workload: str, trace: bool) -> list:
    """The metric entries a run of `workload` reports: the end-to-end ones
    untraced, the per-layer ones traced; a metric with `workloads` only in
    those cells."""
    group = bench['per_layer'] if trace else bench['end_to_end']
    return [m for m in group
            if 'workloads' not in m or workload in m['workloads']]


def derive(seed: int, tag: int) -> int:
    """A 63-bit seed for (run seed, purpose); any whole-number seed."""
    a, b = np.random.SeedSequence([int(seed) & (2 ** 64 - 1),
                                   tag]).generate_state(2)
    return (int(a) << 31 | int(b)) & (2 ** 63 - 1)


SEED_WEIGHTS, SEED_CALIB, SEED_SCENES, SEED_SAMPLE = range(1, 5)


def forbidden_modules() -> list:
    """Top-level names in sys.modules that are JAX's or the JAX package's,
    compared as whole names (`offsetguided_tpu_torch` is the port)."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def guard(where: str) -> None:
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f'{where}: forbidden modules loaded: {bad}')


def make_state(cfg: Dict, traffic: Dict, seed: int, device) -> Dict:
    """The cell's weights, made on the device from the seed, BatchNorm
    statistics calibrated by the plain network on seeded noise at the
    traffic's size; returned on the host, for the program and, after the
    window, the reference."""
    import torch

    from reference.model import PlainPoseNet, make_weights, normalize

    sd = make_weights(cfg, derive(seed, SEED_WEIGHTS), device)
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, SEED_CALIB))
    h, w = traffic['calib_hw']
    noise = torch.randint(0, 256, (4, h, w, 3), generator=g, device=device,
                          dtype=torch.uint8)
    PlainPoseNet(cfg, sd).calibrate_(
        normalize(noise, cfg['pixel_mean'], cfg['pixel_std']))
    host = {k: v.to('cpu') for k, v in sd.items()}
    del sd, noise
    return host


def model_config(cfg: Dict):
    """The port's ModelConfig of a configuration file; the Hourglass-104
    widths (`cnv_dim`, `hg_order`, `dims`, `modules`) where the file has
    them, else `ModelConfig`'s defaults."""
    from offsetguided_tpu_torch.config.defaults import HeadsConfig, ModelConfig
    heads = HeadsConfig(n_keypoints=len(cfg['keypoints']),
                        n_limbs=len(cfg['skeleton']))
    widths = {k: cfg[k] for k in ('cnv_dim', 'hg_order') if k in cfg}
    widths.update({k: tuple(cfg[k]) for k in ('dims', 'modules') if k in cfg})
    return ModelConfig(basenet=cfg['basenet'], n_stacks=cfg['n_stacks'],
                       heads=heads, compute_dtype=cfg['compute_dtype'],
                       **widths)


def device_record(n_chips: int) -> Dict:
    import torch
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': n_chips,
            'memory_peak_bytes': max(torch.cuda.max_memory_allocated(d)
                                     for d in range(n_chips))}
