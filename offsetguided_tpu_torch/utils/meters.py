"""Running meters and throughput tracking."""
from __future__ import annotations

import time


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class Throughput:
    """Items/sec meter on the host clock, skipping the first ticks
    (warm-up). On a device the caller synchronizes before `tick` for the
    rate to count finished work."""

    def __init__(self, skip_first: int = 2):
        self.skip = skip_first
        self.n = 0
        self.items = 0
        self.t0 = None

    def tick(self, batch: int):
        self.n += 1
        if self.n == self.skip:
            self.t0 = time.perf_counter()
            self.items = 0
        elif self.n > self.skip:
            self.items += batch

    @property
    def rate(self) -> float:
        if self.t0 is None or self.items == 0:
            return 0.0
        return self.items / (time.perf_counter() - self.t0)
