"""The port's serving measurement tools end to end on the CPU, with the
tiny model at the smallest sizes: `cli/bench.py`, `cli/bench_serve.py`
(in process, and the server as a subprocess), `cli/bench_e2e.py` (long
edge with and without flip test, fixed height), `cli/profile_forward.py`
and `cli/profile_decode.py --stages`; each prints its JSON line."""
import json

import pytest

from offsetguided_tpu_torch.cli import (bench, bench_e2e, bench_serve,
                                        profile_decode, profile_forward)

TINY = ['--device', 'cpu', '--debug-tiny-model']


def json_lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith('{')]


def test_bench(capsys, monkeypatch):
    monkeypatch.setattr(bench, 'BATCHES', (2, 1))    # CPU-sized run
    monkeypatch.setattr(bench, 'ITERS', 2)
    out = bench.main(TINY + ['--size', '128'])
    assert json_lines(capsys) == [out]
    assert out['metric'] == 'e2e_fps_128' and out['batch'] == 2
    assert out['value'] > 0 and out['flip_value'] > 0
    assert out['vs_baseline'] == round(out['value'] / 30.0, 3)
    assert out['weights'].startswith('random_posenet(seed=0)')


@pytest.mark.parametrize('mode', ['in_process', 'subprocess'])
def test_bench_serve(capsys, mode):
    argv = TINY + ['--long-edge', '128', '--batch-size', '2',
                   '--concurrency', '3', '--duration', '1', '--n-images', '3',
                   '--warmup-requests', '1', '--json']
    out = bench_serve.main(argv + (['--in-process'] if mode == 'in_process'
                                   else []))
    assert json_lines(capsys) == [out]
    assert out['requests'] > 0 and out['client_errors'] == 0
    assert out['qps'] > 0 and out['startup_s'] >= 0
    lat = out['submit_latency_ms' if mode == 'in_process' else 'latency_ms']
    assert 0 < lat['p50'] <= lat['p90'] <= lat['p99']
    server = out['batcher' if mode == 'in_process' else 'server']
    assert server['errors'] == 0 and server['batch_capacity'] == 2
    assert server['requests'] >= out['requests']


def test_make_test_jpegs():
    """Painted hard-set scenes in the hard set's sizes, decodable JPEG."""
    from offsetguided_tpu_torch.data import codec
    from offsetguided_tpu_torch.data.synthetic import SIZES
    blobs = bench_serve.make_test_jpegs(3)
    assert len(blobs) == 3
    for b in blobs:
        assert codec.decode(b).shape[:2] in SIZES


@pytest.mark.parametrize('fixed', [False, True])
def test_bench_e2e(capsys, fixed):
    argv = TINY + ['--long-edge', '128', '--n-images', '3', '--batch-size',
                   '2', '--io-workers', '2']
    argv += (['--fixed-height', '--width-bucket', '128', '--modes', 'noflip']
             if fixed else ['--modes', 'noflip,flip'])
    lines = bench_e2e.main(argv)
    assert json_lines(capsys) == lines
    want = ['fromdisk_fps_fh128'] if fixed else ['fromdisk_fps_128',
                                                 'fromdisk_fps_128_flip']
    assert [x['metric'] for x in lines] == want
    for x in lines:
        assert x['value'] > 0 and x['n_images'] == 3
        assert x['n_results'] >= 3
    if fixed:
        assert lines[0]['n_padded_shapes'] == len(lines[0]['shapes']) >= 1


def test_profile_forward(capsys, tmp_path):
    out = profile_forward.main(TINY + ['--size', '128', '--batch', '2',
                                       '--trace-iters', '1',
                                       '--log-dir', str(tmp_path)])
    assert json_lines(capsys) == [out]
    assert out['ms_per_batch'] > 0 and out['tflop_per_batch'] > 0
    assert 1 <= len(out['top_ops']) <= profile_forward.TOP
    assert all(op['calls'] >= 1 and 0 < op['share'] <= 1
               for op in out['top_ops'])
    assert (tmp_path / 'trace.json').stat().st_size > 0


def test_profile_forward_float32_trace(capsys, tmp_path, monkeypatch):
    """`--dtype float32 --trace` without `--log-dir`: the Chrome trace goes
    into the JAX tool's default, `fwd_trace` in the temporary directory."""
    import tempfile
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    out = profile_forward.main(TINY + ['--size', '64', '--batch', '1',
                                       '--trace-iters', '1', '--dtype',
                                       'float32', '--trace'])
    assert json_lines(capsys) == [out] and out['dtype'] == 'float32'
    assert (tmp_path / 'fwd_trace' / 'trace.json').stat().st_size > 0


def test_profile_decode(capsys, monkeypatch):
    monkeypatch.setattr(profile_decode, 'ITERS', 2)   # CPU-sized run
    out = profile_decode.main(TINY + ['--size', '128', '--batch', '2',
                                      '--stages'])
    assert json_lines(capsys) == [out]
    assert out['decode_ms'] > 0
    assert list(out['stages_ms']) == ['upsample/peaks', 'limb collection',
                                      'grouping', 'inverse']
    assert all(v > 0 for v in out['stages_ms'].values())
    assert len(out['poses_per_image']) == 2
