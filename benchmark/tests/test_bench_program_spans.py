"""The per-layer metrics that read the program's span recorder
(`offsetguided_tpu_torch/utils/profiling.py::RECORDER`), in whole runs
of the tiny cells on the CPU: a traced serve run reports the queue wait,
the loop's host time and the host time of forward and decode; a traced
eval run the last three; the device gap needs CUDA events, so neither
reports it here; an untraced run reports none. A program without the
recorder gives no reading and no error."""
from __future__ import annotations

import math
import sys
import types
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))
sys.path.insert(2, str(Path(__file__).resolve().parent))

import harness  # noqa: E402
import run  # noqa: E402
from test_bench_cells import _tiny_root  # noqa: E402

PROGRAM = ('batcher.wait_ms', 'batcher.wait_ms.img_s', 'batch_gap_ms.infer',
           'loop_host_ms.infer', 'forward_host_ms.infer',
           'decode_host_ms.infer')
SEED = 2 ** 31 + 23


@pytest.fixture(scope='module')
def cpu_root(tmp_path_factory):
    return _tiny_root(tmp_path_factory.mktemp('checkout'))


@pytest.mark.parametrize('workload, want', [
    ('tiny.serve', {'batcher.wait_ms', 'batcher.wait_ms.img_s',
                    'loop_host_ms.infer',
                    'forward_host_ms.infer', 'decode_host_ms.infer'}),
    ('tiny.eval', {'loop_host_ms.infer', 'forward_host_ms.infer',
                   'decode_host_ms.infer'})])
def test_traced_run_reports_the_program_spans(cpu_root, workload, want):
    bench, path = cpu_root
    r = run.run_cell(bench, workload, SEED, 1.5, True, device='cpu',
                     root=path)
    assert r['correct'], r['checks']
    got = {m for m in PROGRAM if m in r['metrics']}
    assert got == want
    for m in want:
        v = r['metrics'][m]['value']
        assert math.isfinite(v) and v > 0, (m, v)
        assert r['metrics'][m]['unit'] == 'ms'
    # the serve tail, which a cell may report per layer
    assert ('request_p95_ms.img_s' in r['metrics']) == (
        workload == 'tiny.serve')


def test_untraced_run_reports_none_of_them(cpu_root):
    bench, path = cpu_root
    r = run.run_cell(bench, 'tiny.serve', SEED, 1.5, False, device='cpu',
                     root=path)
    assert r['correct']
    assert not set(PROGRAM) & set(r['metrics'])


@pytest.mark.parametrize('name', PROGRAM)
def test_a_program_without_the_recorder_reads_nothing(monkeypatch, name):
    bare = types.ModuleType('offsetguided_tpu_torch.utils.profiling')
    monkeypatch.setitem(sys.modules, bare.__name__, bare)
    rec = {'t0': 0.0, 'seconds': 1.0}
    assert harness.metric_reader(name).read(rec) is None
