"""Spans around the program's layers, and the device trace of a stretch.

`Spans` puts `torch.profiler.record_function` ranges around the calls
into the model (forward hooks: `bench.forward:<n>x<h>x<w>`) and the
decoder (`bench.decode:<n>x<h>x<w>`, the PostProcessor's `decode_body`
wrapped on the instance); the harness installs them only in a traced
run. `Capture` runs `torch.profiler` (CPU and CUDA activity) over a
stretch of the window and reads its chrome trace back into a `Trace`:
every device operation, which span launched it, the union of their
intervals (busy time), and the host span under each idle gap. The
profiler records host ranges only on the thread that starts it, so the
forward hook starts and stops it, on the thread that launches the work.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


class Spans:
    """Profiler ranges around the model's forward and the decoder's
    `decode_body`, for the life of the model. `decoded` keeps the host
    time and the number of images of every decode call, profiled or not,
    so that the rate inside the profiled stretch can be set against the
    rate before it: the profiler's own cost."""

    def __init__(self, model, postprocessor, capture: 'Capture' = None):
        self._open = []
        self.decoded = []

        def pre(_, args):
            if capture is not None:
                capture.poll()
            n, h, w = args[0].shape[:3]
            rf = torch.profiler.record_function(f'bench.forward:{n}x{h}x{w}')
            rf.__enter__()
            self._open.append(rf)

        def post(*_):
            self._open.pop().__exit__(None, None, None)

        model.register_forward_pre_hook(pre)
        model.register_forward_hook(post)
        original = postprocessor.decode_body

        def decode_body(preds, flip_test=False):
            n, hs, ws = preds['hmp'][-1].shape[:3]
            n = n // 2 if flip_test else n
            name = f'bench.decode:{n}x{hs * 4}x{ws * 4}'
            with torch.profiler.record_function(name):
                out = original(preds, flip_test=flip_test)
            self.decoded.append((time.perf_counter(), n))
            return out

        object.__setattr__(postprocessor, 'decode_body', decode_body)

    def rate(self, t0: float, t1: float) -> Optional[float]:
        """Images a second decoded in [t0, t1), None for an empty span."""
        if t1 <= t0:
            return None
        return sum(n for t, n in self.decoded if t0 <= t < t1) / (t1 - t0)


class Trace:
    """The device operations of a traced stretch and the host spans."""

    def __init__(self, events: List[dict], window_s: float):
        self.window_s = window_s
        runtime = {}
        spans = defaultdict(list)           # tid -> [(t0, t1, name)]
        self.ops = []                        # (t0, t1, name, correlation)
        for e in events:
            if e.get('ph') != 'X':
                continue
            cat = e.get('cat', '')
            t0 = float(e['ts']) * 1e-6
            t1 = t0 + float(e.get('dur', 0.0)) * 1e-6
            if cat in DEVICE_CATS:
                self.ops.append((t0, t1, e['name'],
                                 e.get('args', {}).get('correlation')))
            elif cat == 'cuda_runtime':
                c = e.get('args', {}).get('correlation')
                if c is not None:
                    runtime[c] = (t0, e.get('tid'))
            elif cat == 'user_annotation' and e['name'].startswith('bench.'):
                spans[e.get('tid')].append((t0, t1, e['name']))
        self.ops.sort()
        self.spans = {t: sorted(v) for t, v in spans.items()}
        self._starts = {t: [s[0] for s in v] for t, v in self.spans.items()}
        self.all_spans = sorted(s for v in self.spans.values() for s in v)
        self._all_starts = [s[0] for s in self.all_spans]
        self._runtime = runtime
        self.launch_span = [self._span_of(c, t0) for t0, _, _, c in self.ops]

    def _open_at(self, t, spans, starts) -> Optional[tuple]:
        """The span (t0, t1, name) of `spans` (sorted, disjoint) open at
        time t."""
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and spans[i][1] >= t:
            return spans[i]
        return None

    def _span_of(self, corr, t_start) -> Optional[tuple]:
        """The benchmark span whose thread launched the op, or the latest
        span begun before the op ran when the launch is not in the
        trace."""
        hit = self._runtime.get(corr)
        if hit is not None:
            t, tid = hit
            return self._open_at(t, self.spans.get(tid, []),
                                 self._starts.get(tid, []))
        i = bisect.bisect_right(self._all_starts, t_start) - 1
        return self.all_spans[i] if i >= 0 else None

    # -- device time ------------------------------------------------------
    def busy_s(self) -> float:
        """Seconds in which at least one device operation ran."""
        return union_seconds([(a, b) for a, b, _, _ in self.ops])

    def layer_seconds(self, prefix: str) -> float:
        """Device seconds of the ops launched inside spans of `prefix`."""
        return sum(b - a for (a, b, _, _), s in zip(self.ops, self.launch_span)
                   if s is not None and s[2].startswith(prefix))

    def n_spans(self, prefix: str) -> int:
        return sum(1 for s in self.all_spans if s[2].startswith(prefix))

    def by_name(self) -> Dict[str, float]:
        out = defaultdict(float)
        for a, b, name, _ in self.ops:
            out[name] += b - a
        return dict(out)

    def idle_gaps(self) -> Dict[str, float]:
        """Idle device seconds between the first and last op, by the host
        span open at each gap's midpoint (`host` where none is)."""
        out = defaultdict(float)
        end = None
        for a, b, _, _ in self.ops:
            if end is not None and a > end:
                span = self._open_at((a + end) / 2, self.all_spans,
                                     self._all_starts)
                out[span[2].split(':')[0] if span else 'host'] += a - end
            end = b if end is None else max(end, b)
        return dict(out)


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def union_seconds(intervals) -> float:
    """Length of the union of [a, b] intervals."""
    total, cur_a, cur_b = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


class Capture:
    """A profiler session over [t_start, t_stop) of the perf_counter
    clock: `poll()`, called on the launching thread before each forward,
    starts it and, once t_stop has passed, stops it; `finish()` stops it
    on the calling thread; `read()`, after the window, returns its
    `Trace`. The chrome trace goes through a temporary file under TMPDIR,
    deleted once read."""

    def __init__(self, t_start: float, t_stop: float):
        self.t_start, self.t_stop = t_start, t_stop
        self._prof = None
        self.t0 = None          # when the profiler started
        self.window_s = None

    @staticmethod
    def prime() -> None:
        """A short session on the calling thread: the profiler's first
        session must start on the thread that loaded it, or the later
        ones, started on the launching thread, record no host ranges."""
        with torch.profiler.profile(activities=_activities()):
            torch.ones(1).sum()

    def poll(self) -> None:
        now = time.perf_counter()
        if self._prof is None and self.window_s is None \
                and self.t_start <= now < self.t_stop:
            self._prof = torch.profiler.profile(activities=_activities())
            self._prof.__enter__()
            self.t0 = time.perf_counter()
        elif self._prof is not None and self.window_s is None \
                and now >= self.t_stop:
            self.finish()

    def finish(self) -> None:
        if self._prof is None or self.window_s is not None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self._prof.__exit__(None, None, None)

    def read(self) -> Optional[Trace]:
        """The trace, or None where the stretch saw no call."""
        if self._prof is None:
            return None
        self.finish()
        fd, path = tempfile.mkstemp(suffix='.json')
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get('traceEvents', [])
        finally:
            os.unlink(path)
        self._prof = None
        return Trace(events, self.window_s)
