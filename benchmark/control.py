"""Readings of the output check over many seeds in one process.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \\
        --seconds 3 [--mode program|fp8|half_batch|altered]

Runs the cell once a seed as `run.py` runs it, at its own sizes and load,
and prints one JSON line a seed with the numbers the check compares at
every tolerance of the traffic. `program` is the timed path as the
benchmark runs it: its readings over a dozen seeds or more are the lower
reading of each limit. `fp8` puts the plain reference in the program's
place with every backbone convolution in float8 e4m3 (the precision below
the configuration's bf16): the control, whose readings are the upper
reading. `half_batch` and `altered` plant a fault in the timed path. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import run
import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--seconds', type=float, default=3.0)
    p.add_argument('--mode', default='program',
                   choices=['program', 'fp8', 'half_batch', 'altered'])
    args = p.parse_args(argv)
    bench = harness.load_json(run.ROOT / 'BENCHMARK.json')
    control = 'fp8' if args.mode == 'fp8' else None
    fault = args.mode if args.mode in ('half_batch', 'altered') else None
    for seed in (int(s) for s in args.seeds.split(',')):
        t = time.perf_counter()
        r = run.run_cell(bench, args.workload, seed, args.seconds, False,
                         control=control, fault=fault)
        print(json.dumps({'workload': args.workload, 'mode': args.mode,
                          'seed': seed, 'correct': r['correct'],
                          'attempted': r['attempted'], 'failed': r['failed'],
                          'numbers': r['numbers'],
                          'diagnostics': r['diagnostics'],
                          'metrics': r['metrics'],
                          'seconds': time.perf_counter() - t}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
