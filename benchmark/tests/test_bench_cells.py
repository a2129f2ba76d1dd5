"""Whole runs of the harness on the CPU at a tiny size, and on the card.

A temporary checkout holds the benchmark's files plus two tiny
configurations (a narrow Hourglass-104, and the 4-stage hourglass at its
own widths with one stack), three tiny traffic mixes, their limits and
one more metric, all added as new files and entries, none edited: so
these tests also show that a cell, a configuration whose `basenet` names
another plain network, a mix and a metric are additions. The runs
skip the harness's look for a chip and drive the rest: set-up, window,
the output check against the plain reference. A sound run is correct (at
float32 the port's CPU path meets the reference to rounding); each planted
fault and the float8 control make `correct` false.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))

import run  # noqa: E402

TINY = {'n_stacks': 1, 'hg_order': 2, 'dims': [8, 8, 12],
        'modules': [1, 1, 1], 'cnv_dim': 8, 'compute_dtype': 'float32'}
# the 4-stage net names only its backbone and depth; its scenes are 128
# high, a multiple of its stride of 64
TINY4 = {'basenet': 'hourglass4stage', 'n_stacks': 1,
         'compute_dtype': 'float32'}
HG104_WIDTHS = ('hg_order', 'dims', 'modules', 'cnv_dim')
CELLS = ['tiny.serve', 'tiny.eval', 'tiny4.serve', 'tiny4.eval']
LIMITS = {'limits': {'maps_rel_err': 1e-4, 'decode_mismatch': 0.0,
                     'answer_mismatch': 0.0, 'inputs_unmatched': 0.0}}
EXTRA_METRIC = '''"""Images a second of the window, per stream."""


def read(rec):
    return rec['images'] / rec['seconds'] / 3 if rec.get('seconds') else None
'''


def _tiny_root(tmp: Path) -> tuple:
    shutil.copytree(HERE, tmp / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    b = tmp / 'benchmark'
    cfg = json.loads((HERE / 'configs' / 'hg104-coco.json').read_text())
    cfg.update(TINY, name='tiny')
    (b / 'configs' / 'tiny.json').write_text(json.dumps(cfg))
    cfg = {k: v for k, v in cfg.items() if k not in HG104_WIDTHS}
    cfg.update(TINY4, name='tiny4')
    (b / 'configs' / 'tiny4.json').write_text(json.dumps(cfg))
    serve = json.loads((HERE / 'traffic' / 'serve.json').read_text())
    serve.update(sizes=[[96, 128], [128, 96], [128, 128]], n_scenes=4,
                 calib_hw=[128, 128], long_edge=128, batch=2, concurrency=3,
                 n_check=6, tap={'first': 2, 'step': 2, 'count': 3})
    (b / 'traffic' / 'tiny-serve.json').write_text(json.dumps(serve))
    ev = json.loads((HERE / 'traffic' / 'eval-fh-flip.json').read_text())
    ev.update(sizes=[[128, 96], [128, 128], [128, 200]], n_scenes=5,
              calib_hw=[128, 128], long_edge=128, max_stride=32,
              width_bucket=64, batch=2, io_workers=2)
    (b / 'traffic' / 'tiny-eval.json').write_text(json.dumps(ev))
    ev.update(max_stride=64)
    (b / 'traffic' / 'tiny4-eval.json').write_text(json.dumps(ev))
    (b / 'metrics' / 'stream_rate.py').write_text(EXTRA_METRIC)
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    for name in ('tiny', 'tiny4'):
        bench['configs'].append({'name': name, 'source': 'test',
                                 'file': f'benchmark/configs/{name}.json',
                                 'reduced': [], 'why': 'test'})
    for name, traffic in zip(CELLS, ('tiny-serve', 'tiny-eval', 'tiny-serve',
                                     'tiny4-eval')):
        bench['workloads'].append({'name': name,
                                   'config': name.split('.')[0],
                                   'traffic': traffic, 'chips': 1,
                                   'why': 'test'})
        (b / 'limits' / f'{name}.json').write_text(json.dumps(LIMITS))
    for m in bench['end_to_end'] + bench['per_layer']:
        if 'workloads' in m:
            m['workloads'] += CELLS
    bench['end_to_end'].append({'name': 'stream_rate', 'unit': 'img/s',
                                'better': 'higher', 'bound': 0.05,
                                'source': 'host_clock',
                                'workloads': ['tiny.serve']})
    return bench, tmp


@pytest.fixture(scope='module')
def cpu_root(tmp_path_factory):
    return _tiny_root(tmp_path_factory.mktemp('checkout'))


def _run(root, workload, **kw):
    bench, path = root
    return run.run_cell(bench, workload, 2 ** 31 + 11, 1.5, False,
                        device=kw.pop('device', 'cpu'), root=path, **kw)


@pytest.mark.parametrize('workload', CELLS)
def test_sound_run_is_correct_and_reports_its_metrics(cpu_root, workload):
    r = _run(cpu_root, workload)
    assert r['correct'], r['checks']
    assert r['failed'] == 0 and r['attempted'] > 0
    assert r['numbers']['maps_rel_err'] < 1e-4
    assert r['diagnostics']['answers_checked'] > 0
    # at float32 the reference's decode of its own maps gives the same poses
    assert r['diagnostics']['own_maps_pose_mismatch']['widest'] == 0.0
    assert {'infer_img_s', 'setup_s'} <= set(r['metrics'])
    assert list(r)[-1] == 'checks'
    if workload.endswith('.serve'):
        assert 'request_p95_ms' in r['metrics']
    if workload == 'tiny.serve':
        assert r['metrics']['stream_rate']['value'] > 0    # the added metric


@pytest.mark.parametrize('workload', CELLS)
@pytest.mark.parametrize('fault', ['half_batch', 'altered'])
def test_a_planted_fault_is_not_correct(cpu_root, workload, fault):
    assert not _run(cpu_root, workload, fault=fault)['correct']


@pytest.mark.parametrize('workload', CELLS)
def test_the_float8_control_is_not_correct(cpu_root, workload):
    r = _run(cpu_root, workload, control='fp8')
    assert not r['correct']
    assert r['numbers']['maps_rel_err'] > 1e-2


def test_traced_run_reports_per_layer_metrics(cpu_root):
    bench, path = cpu_root
    r = run.run_cell(bench, 'tiny.serve', 5, 1.5, True, device='cpu',
                     root=path)
    assert r['correct']
    assert 'batcher.fill' in r['metrics'] and 'infer_img_s' not in r['metrics']
    assert 'window_s' in r['device'] and 'breakdown' in r
    prof = r['diagnostics']['profiler']
    assert prof['decoded_img_s_before'] > 0 and prof['decoded_img_s_traced'] > 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return 'cuda'


@pytest.mark.gpu
@pytest.mark.parametrize('workload', CELLS)
def test_on_the_card_stages_are_exact_and_the_control_is_far_off(
        card, tmp_path, workload):
    root = _tiny_root(tmp_path)
    sound = _run(root, workload, device=card)
    control = _run(root, workload, device=card, control='fp8')
    assert sound['numbers']['decode_mismatch'] == 0.0
    assert sound['numbers']['answer_mismatch'] == 0.0
    assert control['numbers']['maps_rel_err'] > \
        3 * sound['numbers']['maps_rel_err']
