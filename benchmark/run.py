"""One run of one cell of the benchmark of `offsetguided_tpu_torch`.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (imports, the CUDA context, the seeded weights, the program's
build and warm-up) is timed from the start of the process; then the
window runs for `--seconds`; then the program is freed and its answers
are checked against the plain reference. The last line of standard
output is the result, a JSON object; the numbers compared and their
limits are the last lines of standard error. `--trace 1` runs the
profiler over a stretch of the window and reports the per-layer metrics
instead of the end-to-end ones. Needs a CUDA device; never imports JAX
or the JAX package.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
if str(ROOT) not in sys.path:
    sys.path.insert(1, str(ROOT))
# build and kernel caches at fixed paths inside the checkout
CACHE = ROOT / '.bench_cache'
os.environ.setdefault('TORCH_EXTENSIONS_DIR', str(CACHE / 'torch_extensions'))
os.environ.setdefault('TRITON_CACHE_DIR', str(CACHE / 'triton'))
os.environ.setdefault('USE_FLAX', '0')

import harness  # noqa: E402

# the profiled stretch: the window's last TRACE_SHARE, at most
# TRACE_MAX_S seconds; it runs to the window's close
TRACE_MAX_S, TRACE_SHARE = 2.0, 0.3
# the window's rate is also given slice by slice, a diagnostic of its
# steadiness
SLICE_S = 5.0


def rates_by_slice(done_at, t0: float, seconds: float,
                   width: float) -> list:
    """Images a second completed in each `width`-second slice of the
    window [t0, t0 + seconds); `done_at` holds (time, images)."""
    width = min(width, seconds)
    n = int(seconds // width)
    counts = [0] * n
    for t, k in done_at:
        i = int((t - t0) // width)
        if 0 <= i < n:
            counts[i] += k
    return [c / width for c in counts]


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str = 'cuda', control: str = None,
             fault: str = None, t_process: float = None,
             root: Path = ROOT) -> dict:
    """Set-up, window, check of one cell; returns the result object
    (`checks` last). `control` / `fault` replace the timed path by the
    reference at a lower precision or plant a fault, for the checks of
    the comparison; the benchmark's own runs use neither."""
    import torch

    from compare import judge
    from trace import Capture

    c = harness.cell(bench, workload, root)
    wl = c['workload']
    ctx = SimpleNamespace(cfg=c['config'], traffic=c['traffic'], seed=seed,
                          device=device, control=control,
                          fault=fault, capture=None)
    mod = harness.entry(c['traffic'], root)
    t_setup0 = time.perf_counter() if t_process is None else t_process
    if trace:
        # the schedule is set relative to the window's start below
        Capture.prime()
        ctx.capture = Capture(float('inf'), float('inf'))
    st = mod.setup(ctx)
    harness.guard('after set-up')
    if device != 'cpu':
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_setup0
    if trace:
        ctx.capture.t_start = time.perf_counter() + seconds - min(
            TRACE_MAX_S, TRACE_SHARE * seconds)
    out = mod.window(st, seconds)
    harness.guard('after the window')
    dev_rec = (harness.device_record(wl['chips']) if device != 'cpu'
               else {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                     'memory_peak_bytes': 0})
    rec = mod.record(st, out)
    rec.update(setup_s=setup_s, trace=None, traffic=ctx.traffic)
    steadiness = {'img_s_by_5s': rates_by_slice(rec['done_at'], rec['t0'],
                                                  seconds, SLICE_S)}
    if trace:
        tr = ctx.capture.read()
        rec['trace'] = tr
        if tr is not None:
            dev_rec['busy_s'] = tr.busy_s()
            dev_rec['window_s'] = tr.window_s
            cap, spans = ctx.capture, st['spans']
            steadiness['profiler'] = {
                'decoded_img_s_before': spans.rate(rec['t0'], cap.t0),
                'decoded_img_s_traced': spans.rate(cap.t0,
                                                   cap.t0 + cap.window_s)}
    mod.release(st)
    numbers, attempted, failed, diag = mod.check(st, out)
    diag.update(steadiness)
    limits = (c['limits'] or {}).get('limits', {})
    checks = judge(numbers, limits)
    correct = (failed == 0 and bool(checks)
               and all(v <= lim for _, v, lim in checks))
    metrics = {}
    for m in harness.metrics_of(bench, workload, trace):
        v = harness.metric_reader(m['name'], root).read(rec)
        if v is not None:
            metrics[m['name']] = {'value': v, 'unit': m['unit']}
    result = {'correct': correct, 'attempted': attempted, 'failed': failed,
              'metrics': metrics, 'device': dev_rec}
    if trace and rec['trace'] is not None:
        t = rec['trace']
        ops = sorted(t.by_name().items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(t.idle_gaps().items(), key=lambda kv: -kv[1])[:10]
        result['breakdown'] = {'device_ops': [[k, v] for k, v in ops],
                               'idle_gaps': [[k, v] for k, v in gaps]}
    result['numbers'], result['diagnostics'] = numbers, diag
    result['checks'] = {name: {'value': v, 'limit': lim}
                        for name, v, lim in checks}
    return result


def main(argv=None) -> int:
    args = cli(argv)
    bench = harness.load_json(ROOT / 'BENCHMARK.json')
    wl = next((w for w in bench['workloads'] if w['name'] == args.workload),
              None)
    if wl is None:
        print(f'no workload {args.workload!r}', file=sys.stderr)
        return 2
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < wl['chips']:
        print(f'needs {wl["chips"]} CUDA device(s); found {found}',
              file=sys.stderr)
        return 3
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), t_process=T_PROCESS)
    bad = harness.forbidden_modules()
    if bad:
        print(f'forbidden modules loaded: {bad}', file=sys.stderr)
        return 4
    for name, c in result['checks'].items():
        print(f'check {name} = {c["value"]!r} (limit {c["limit"]!r})',
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
