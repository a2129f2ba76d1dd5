#!/usr/bin/env python
"""Load benchmark for the pose-serving endpoint (`cli/serve.py`).

Port of the JAX package's `cli/bench_serve.py`, with its flags and JSON
line plus `--device`. Starts the port's server as a subprocess
(`python -m offsetguided_tpu_torch.cli.serve`), waits for /healthz
(recording the cold start: imports, model init, BatchNorm calibration and
the warm-up batch), then drives a closed loop of `--concurrency` clients
posting JPEGs for `--duration` seconds and reports:

- sustained QPS (completed requests / wall time)
- client-observed request latency p50/p90/p99 (ms)
- the server's /metrics (device-batch latency percentiles, mean fill)

The JPEGs are painted hard-set scenes (`data/synthetic.py`) encoded by the
port's codec at quality 95. `--in-process` drives `serve.Batcher` directly
(no HTTP, no subprocess, images decoded and preprocessed once) and also
reports the device time of one resident batch: the serving ceiling.

    python -m offsetguided_tpu_torch.cli.bench_serve --concurrency 16 \\
        --duration 30 [--batch-size 8] [--json]
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np


def free_port() -> int:
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def make_test_jpegs(n: int, seed: int = 0) -> list:
    """`n` painted hard-set scenes as JPEG bodies (quality 95, 4:2:0)."""
    from ..data import codec
    from ..data.synthetic import hard_annotations, paint_figures

    blobs = []

    def encode(_, img, persons):
        for kps in persons:
            paint_figures(img, kps)
        blobs.append(codec.encode_jpeg(img[:, :, ::-1]))

    hard_annotations(n, seed, on_image=encode)
    return blobs


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--concurrency', type=int, default=16,
                   help='closed-loop client threads')
    p.add_argument('--duration', type=float, default=30.0,
                   help='measured load phase seconds (after warmup)')
    p.add_argument('--warmup-requests', type=int, default=16)
    p.add_argument('--n-images', type=int, default=24,
                   help='distinct JPEG payloads cycled by the clients')
    p.add_argument('--batch-size', type=int, default=8)
    p.add_argument('--batch-window-ms', type=float, default=5.0)
    p.add_argument('--long-edge', type=int, default=640)
    p.add_argument('--flip-test', action='store_true')
    p.add_argument('--debug-tiny-model', action='store_true')
    p.add_argument('--startup-timeout-s', type=float, default=1800.0)
    p.add_argument('--json', action='store_true', help='one-line JSON output')
    p.add_argument('--in-process', action='store_true',
                   help='drive the micro-batcher directly (no HTTP, no '
                        'subprocess, preprocessed images): the device-side '
                        'serving ceiling')
    p.add_argument('--device', default=None,
                   help='torch device (default: the card)')
    return p.parse_args(argv)


def _serve_argv(args) -> list:
    argv = ['--batch-size', str(args.batch_size),
            '--batch-window-ms', str(args.batch_window_ms),
            '--long-edge', str(args.long_edge)]
    for flag in ('flip_test', 'debug_tiny_model'):
        if getattr(args, flag):
            argv.append('--' + flag.replace('_', '-'))
    if args.device is not None:
        argv += ['--device', args.device]
    return argv


def closed_loop(call, n_items: int, concurrency: int, duration: float):
    """`concurrency` threads call `call(i)` back to back for `duration`
    seconds (thread w takes items w, w + concurrency, ...); returns
    (latencies in s, errors, wall seconds)."""
    lats, errors = [], []
    lock = threading.Lock()
    stop = threading.Event()

    def worker(wid: int):
        i, mine, mine_err = wid, [], 0
        try:
            while not stop.is_set():
                t0 = time.monotonic()
                try:
                    call(i % n_items)
                    mine.append(time.monotonic() - t0)
                except Exception:
                    if stop.is_set():   # teardown race: not a failure
                        break
                    mine_err += 1       # count it, keep the thread alive
                i += concurrency
        finally:
            # bank this thread's samples whatever happened
            with lock:
                lats.extend(mine)
                errors.append(mine_err)

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(concurrency)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    time.sleep(duration)
    stop.set()
    for t in threads:
        t.join()
    return lats, sum(errors), time.monotonic() - t0


def percentiles(lats) -> dict:
    """p50 / p90 / p99 (element min(int(q n), n - 1) of the sorted
    latencies) and the mean, in ms to 0.1 ms."""
    lats = sorted(lats)
    n = len(lats)

    def pct(q):
        return round(lats[min(int(q * n), n - 1)] * 1e3, 1)

    return {'p50': pct(0.50), 'p90': pct(0.90), 'p99': pct(0.99),
            'mean': round(statistics.mean(lats) * 1e3, 1)}


def _emit(out: dict, as_json: bool) -> None:
    print(json.dumps(out) if as_json else json.dumps(out, indent=2),
          flush=True)


def run_in_process(args) -> dict:
    """The device-side micro-batcher ceiling: `serve.Batcher` driven
    directly with images decoded and preprocessed once, plus the device
    time of the infer on one resident batch."""
    import torch

    from ..data import codec
    from ..device import resolve_device
    from ..eval.harness import preprocess_eval
    from ..utils.profiling import device_time
    from . import serve as serve_mod

    sargs = serve_mod.cli(_serve_argv(args))
    dev = resolve_device(sargs.device)
    t0 = time.monotonic()
    infer, skeleton, eval_cfg, _ = serve_mod.build_infer(
        sargs, serve_mod.model_config(sargs), None, dev)
    n_kp = skeleton.n_keypoints
    imgs, metas = [], []
    for blob in make_test_jpegs(args.n_images):
        fimg, _, meta = preprocess_eval(
            codec.decode(blob), np.zeros((0, n_kp, 4), np.float32),
            eval_cfg, n_kp)
        imgs.append(fimg)
        metas.append(meta)
    resident = torch.from_numpy(np.stack(
        [imgs[i % len(imgs)] for i in range(args.batch_size)])).to(dev)
    infer(resident)[2].cpu()
    startup_s = time.monotonic() - t0
    floor_s = device_time(infer, resident, iters=4)

    batcher = serve_mod.Batcher(infer, args.batch_size, args.batch_window_ms,
                                dev)
    try:
        lats, n_err, wall = closed_loop(
            lambda i: batcher.submit(imgs[i], metas[i]), len(imgs),
            args.concurrency, args.duration)
        metrics = batcher.metrics()
    finally:
        batcher.close()
    if not lats:
        out = {'error': 'no requests completed', 'client_errors': n_err}
        _emit(out, args.json)
        return out
    out = {
        'mode': 'in_process',
        'qps': round(len(lats) / wall, 2),
        'requests': len(lats),
        'client_errors': n_err,
        'duration_s': round(wall, 1),
        'concurrency': args.concurrency,
        'batch_size': args.batch_size,
        'batch_window_ms': args.batch_window_ms,
        'flip_test': args.flip_test,
        'startup_s': round(startup_s, 1),
        'device_floor_ms_per_batch': round(floor_s * 1e3, 1),
        'device_floor_qps_at_full_fill': round(args.batch_size / floor_s, 1),
        'submit_latency_ms': percentiles(lats),
        'batcher': metrics,
    }
    _emit(out, args.json)
    return out


def main(argv=None) -> dict:
    args = cli(argv)
    if args.in_process:
        return run_in_process(args)
    port = free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [root] + ([env['PYTHONPATH']] if env.get('PYTHONPATH') else []))
    cmd = ([sys.executable, '-m', 'offsetguided_tpu_torch.cli.serve',
            '--port', str(port)] + _serve_argv(args))
    blobs = make_test_jpegs(args.n_images)
    base = f'http://127.0.0.1:{port}'

    t_start = time.monotonic()
    log = tempfile.TemporaryFile()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                            stderr=log)
    try:
        startup_s = None
        while time.monotonic() - t_start < args.startup_timeout_s:
            if proc.poll() is not None:
                log.seek(0)
                raise RuntimeError(f'server exited rc={proc.returncode}: '
                                   f'{log.read().decode()[-2000:]}')
            try:
                with urllib.request.urlopen(base + '/healthz', timeout=2) as r:
                    if r.status == 200:
                        startup_s = time.monotonic() - t_start
                        break
            except OSError:
                time.sleep(0.5)
        if startup_s is None:
            raise TimeoutError('server did not become healthy')

        def post(i: int) -> None:
            req = urllib.request.Request(
                base + '/v1/poses', data=blobs[i],
                headers={'Content-Type': 'image/jpeg'})
            with urllib.request.urlopen(req, timeout=120) as r:
                json.loads(r.read())

        for i in range(args.warmup_requests):
            post(i % len(blobs))
        lats, n_err, wall = closed_loop(post, len(blobs), args.concurrency,
                                        args.duration)
        with urllib.request.urlopen(base + '/metrics', timeout=5) as r:
            server_metrics = json.loads(r.read())
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()

    if not lats:
        out = {'error': 'no requests completed', 'client_errors': n_err,
               'startup_s': round(startup_s, 1)}
        _emit(out, args.json)
        return out
    out = {
        'qps': round(len(lats) / wall, 2),
        'requests': len(lats),
        'client_errors': n_err,
        'duration_s': round(wall, 1),
        'concurrency': args.concurrency,
        'batch_size': args.batch_size,
        'batch_window_ms': args.batch_window_ms,
        'flip_test': args.flip_test,
        'startup_s': round(startup_s, 1),
        'latency_ms': percentiles(lats),
        'server': server_metrics,
    }
    _emit(out, args.json)
    return out


if __name__ == '__main__':
    main()
