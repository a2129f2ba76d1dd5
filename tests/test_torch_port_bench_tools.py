"""The port's training benchmarks on the CPU at their smallest sizes:
`cli/bench_train.py` (plain, and the device augmentation on either warp)
prints the JAX tool's JSON keys; `cli/bench_warp.py` times both warps
and `augment_batch`, the two within the JAX package's tolerance of each
other; every `cli/bench_stem.py` formulation equals the JAX tool's
`stem_plain` (`lax.conv_general_dilated`, NHWC / HWIO, stride 2, torch
padding 3, + bias, ReLU; computed here rather than imported, because
importing the JAX tool turns on a persistent compile cache for the
process) within 1e-5 in fp32. And every `og-*` script of the JAX package
has its counterpart in the port."""
import importlib
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offsetguided_tpu_torch.cli import bench_stem, bench_train, bench_warp

# the suite's worker processes share the host's cores
torch.set_num_threads(2)

CPU = ['--device', 'cpu']


def json_lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith('{')]


@pytest.mark.parametrize('extra,warp', [
    ([], None), (['--device-aug', '--warp-impl', 'patch'], 'patch'),
    (['--device-aug'], 'tiled')],
    ids=['resident', 'device_aug_patch', 'device_aug_tiled'])
def test_bench_train(capsys, extra, warp):
    out = bench_train.main(CPU + ['--debug-tiny-model', '--batch-size', '1',
                                  '--square-length', '32', '--raw-canvas',
                                  '40', '--n1', '1', '--n2', '2'] + extra)
    assert json_lines(capsys) == [out]
    assert out['metric'] == 'train_step_imgs_per_sec' and out['unit'] == 'img/s'
    assert out['value'] > 0
    cfg = out['config']
    assert {'batch', 'square', 'remat', 'device_aug', 'tiny',
            'step_ms'} <= cfg.keys()
    assert cfg['batch'] == 1 and cfg['square'] == 32 and cfg['tiny']
    assert cfg['device_aug'] == bool(extra) and cfg['step_ms'] > 0
    assert cfg['warp_impl'] == warp
    assert cfg['device'] == 'cpu'


def test_bench_warp(capsys):
    out = bench_warp.main(CPU + ['--batch-size', '1', '--raw-canvas', '48',
                                 '--square-length', '32', '--full'])
    text = capsys.readouterr().out
    for name in ('patch', 'tiled'):
        assert out['warp_ms'][name] > 0 and out['augment_batch_ms'][name] > 0
        assert f'warp[{name}]' in text and f'augment_batch[{name}]' in text
    assert out['within_tolerance'] and out['max_abs_diff'] <= 0.05
    assert out['device'] == 'cpu'


def test_bench_warp_one_impl(capsys):
    out = bench_warp.main(CPU + ['--batch-size', '1', '--raw-canvas', '40',
                                 '--square-length', '16', '--impls', 'tiled',
                                 '--lane-chunk', '8', '--row-tile', '4'])
    assert list(out['warp_ms']) == ['tiled'] and 'max_abs_diff' not in out


def jax_stem_plain(x, kernel, bias):
    y = jax.lax.conv_general_dilated(
        x, kernel, (2, 2), padding=((3, 3), (3, 3)),
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'))
    return jax.nn.relu(y + bias)


@pytest.mark.parametrize('name', list(bench_stem.VARIANTS))
def test_stem_variant_equals_jax_plain(name):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 48, 3).astype(np.float32)
    kernel = (rng.randn(7, 7, 3, 16) * 0.05).astype(np.float32)
    bias = rng.randn(16).astype(np.float32)
    ref = np.asarray(jax_stem_plain(jnp.asarray(x), jnp.asarray(kernel),
                                    jnp.asarray(bias)))
    for fmt in (torch.contiguous_format, torch.channels_last):
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
            memory_format=fmt)
        out = bench_stem.VARIANTS[name](
            xt, torch.from_numpy(kernel).permute(3, 2, 0, 1).contiguous(),
            torch.from_numpy(bias))
        np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref,
                                   rtol=0, atol=1e-5)


def test_bench_stem_checks_every_variant(capsys):
    out = bench_stem.main(CPU + ['--batch', '1', '--size', '16',
                                 '--features', '4', '--dtype', 'float32'])
    keys = {f'{n}/{lay}' for n in bench_stem.VARIANTS
            for lay in ('nchw', 'channels_last')}
    assert out['ms'].keys() == out['ok'].keys() == keys
    assert all(out['ok'].values()) and all(v > 0 for v in out['ms'].values())
    assert 'DIFFERS' not in capsys.readouterr().out


def test_every_og_script_has_a_port_counterpart():
    text = (Path(__file__).parents[1] / 'pyproject.toml').read_text()
    mods = re.findall(r'^og-[\w-]+ = "offsetguided_tpu\.cli\.(\w+):main"',
                      text, flags=re.M)
    assert len(mods) == 15
    for m in mods:
        mod = importlib.import_module(f'offsetguided_tpu_torch.cli.{m}')
        assert callable(mod.main), m
