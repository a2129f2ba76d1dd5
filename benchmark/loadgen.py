"""Closed-loop load and latency percentiles.

Copies of the port's `cli/bench_serve.py::closed_loop` and of the order
statistic its `percentiles` takes, kept here so that a later change to
the program cannot move the yardstick. `closed_loop` also keeps every
request's submit and answer times and its answer, so that the window's
rate, its tail and the check of the answers all read the same requests.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, NamedTuple


class Request(NamedTuple):
    item: int           # which input
    t_submit: float     # perf_counter seconds
    t_done: float
    answer: object      # None where the call raised
    error: str


def closed_loop(call: Callable, n_items: int, concurrency: int,
                duration: float, on_start: Callable = None) -> tuple:
    """`concurrency` threads call `call(i)` back to back until `duration`
    seconds have passed (thread w takes items w, w + concurrency, ...);
    each thread finishes the call it is in. Returns (requests, window
    start, window end). `on_start(t0)` runs in the calling thread once the
    threads are started (the profiler's schedule)."""
    done: List[Request] = []
    lock = threading.Lock()
    stop = threading.Event()

    def worker(wid: int):
        i, mine = wid, []
        try:
            while not stop.is_set():
                t0 = time.perf_counter()
                try:
                    ans, err = call(i % n_items), ''
                except Exception as e:      # counted as failed, loop goes on
                    ans, err = None, f'{type(e).__name__}: {e}'
                mine.append(Request(i % n_items, t0, time.perf_counter(),
                                    ans, err))
                i += concurrency
        finally:
            with lock:
                done.extend(mine)

    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(concurrency)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    if on_start is not None:
        on_start(t_start)
    time.sleep(max(0.0, t_start + duration - time.perf_counter()))
    t_end = time.perf_counter()
    stop.set()
    for t in threads:
        t.join(60.0)
    return done, t_start, t_end


def percentile(values, q: float) -> float:
    """Element min(int(q n), n - 1) of the sorted values, as the port's
    `percentiles` takes it."""
    v = sorted(values)
    return v[min(int(q * len(v)), len(v) - 1)]
