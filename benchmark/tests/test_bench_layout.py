"""BENCHMARK.json against the benchmark's contract, and the files a cell
is made of: every name resolves to a file that loads, names and units use
the allowed characters, and nothing under benchmark/ imports JAX or the
JAX package (the reference imports nothing of the port either)."""
from __future__ import annotations

import ast
import json
import re
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))

import harness  # noqa: E402

BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
LINE = re.compile(r'^[^\n\t]{1,200}$')
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['benchmark']
    assert BENCH['command'][1].startswith('benchmark/')
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len((ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        names = [e['name'] for e in BENCH[group]]
        assert len(names) == len(set(names))
        for e in BENCH[group]:
            assert NAME.match(e['name']), e['name']
            for key in ('why', 'layer', 'source'):
                if key in e and group != 'end_to_end' and group != 'per_layer':
                    assert LINE.match(e[key]), (e['name'], key)
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert UNIT.match(m['unit']), m['unit']
        assert m['better'] in ('lower', 'higher')
        assert m['source'] in SOURCES
    for m in BENCH['per_layer']:
        assert LINE.match(m['layer'])
    for w in BENCH['workloads']:
        assert NAME.match(w['config']) and NAME.match(w['traffic'])
        assert w['chips'] in (1, 4)


def test_entry_keys():
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
    for m in BENCH['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                         'source'}
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for m in BENCH['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source',
                                         'layer', 'moves'}


def test_every_cell_reports_what_it_must():
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    assert 'setup_s' in e2e
    cells = {w['name'] for w in BENCH['workloads']}
    for w in cells:
        own = [m['name'] for m in harness.metrics_of(BENCH, w, False)]
        assert 'setup_s' in own and len(own) >= 2
        assert harness.metrics_of(BENCH, w, True)
    for m in BENCH['per_layer']:
        assert m['moves'] in e2e
        for w in m.get('workloads', []):
            assert w in cells
            assert m['moves'] in [x['name'] for x in
                                  harness.metrics_of(BENCH, w, False)]
    used = {w['config'] for w in BENCH['workloads']}
    assert used == {c['name'] for c in BENCH['configs']}


def test_every_name_resolves_to_a_file_that_loads():
    for w in BENCH['workloads']:
        c = harness.cell(BENCH, w['name'])
        assert c['limits'] is not None and c['limits']['limits']
        assert hasattr(harness.entry(c['traffic']), 'setup')
    for c in BENCH['configs']:
        assert (ROOT / c['file']).is_file()
        assert c['file'].startswith('benchmark/')
        cfg = json.loads((ROOT / c['file']).read_text())
        assert cfg['reduced'] == c['reduced']
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert callable(harness.metric_reader(m['name']).read)


FORBIDDEN = {'jax', 'jaxlib', 'flax', 'optax', 'offsetguided_tpu'}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            out.add(node.module.split('.')[0])
    return out


@pytest.mark.parametrize('path', sorted(HERE.rglob('*.py')),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize('path', sorted((HERE / 'reference').rglob('*.py')),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    assert 'offsetguided_tpu_torch' not in _imports(path)
    assert not _imports(path) & {'harness', 'entries', 'tap', 'stages'}


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'offsetguided_tpu_torch_fake', object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'offsetguided_tpu.ops', object())
    monkeypatch.setitem(sys.modules, 'jax.numpy', object())
    assert harness.forbidden_modules() == ['jax', 'offsetguided_tpu']
    with pytest.raises(SystemExit):
        harness.guard('test')


def test_the_port_loads_no_jax():
    import offsetguided_tpu_torch.cli.serve  # noqa: F401
    import offsetguided_tpu_torch.eval.harness  # noqa: F401
    assert harness.forbidden_modules() == []
