"""A kernel family's share of its roofline over a traced stretch.

Each call of the family is the decode span (`bench.decode:<n>x<h>x<w>`)
that launched its kernels; its bound comes from that span's shape
(`kernels.counts`). The share is the calls' summed bound over the
family's summed device time. No call traced, no share.
"""
from __future__ import annotations

from typing import Optional

import kernels


def share(rec: dict, fam: str) -> Optional[float]:
    t = rec.get('trace')
    if t is None:
        return None
    calls, seconds = set(), 0.0
    for (a, b, name, _), span in zip(t.ops, t.launch_span):
        if kernels.family(name) != fam:
            continue
        seconds += b - a
        if span is not None and span[2].startswith('bench.decode:'):
            calls.add(span)
    if not calls or seconds <= 0:
        return None
    bound = 0.0
    for _, _, name in calls:
        n, h, w = (int(v) for v in name.split(':')[1].split('x'))
        bound += kernels.bound_s(*kernels.counts(fam, n, h, w, rec['cfg']))
    return 100.0 * bound / seconds
