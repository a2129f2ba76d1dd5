"""The device stages the program times itself (`Recorder.device_stage` of
`offsetguided_tpu_torch/utils/profiling.py`): in one batch in four of
its serving or evaluation loop, CUDA events around a named part of the
network's forward, read without a sync once they have completed. Only
the 4-stage net names stages (`net.dilated`, `net.se`); a CPU run, a
program without the records, or a window without them gives none.
"""
from __future__ import annotations

from typing import Dict, List


def records(rec: dict, name: str) -> List:
    """The window's records of stage `name`: each has `batch`, `ms`,
    `shape` (N, C, H, W of the stage's input) and `dtype`."""
    if not rec.get('seconds'):
        return []
    try:
        from offsetguided_tpu_torch.utils.profiling import RECORDER
    except ImportError:             # a program without the recorder
        return []
    w = RECORDER.window(rec['t0'], rec['t0'] + rec['seconds'])
    return [s for s in getattr(w, 'stages', ()) if s.name == name]


def ms_by_batch(rec: dict, name: str) -> Dict[int, float]:
    """Device ms of stage `name` summed over each sampled batch."""
    out: Dict[int, float] = {}
    for s in records(rec, name):
        out[s.batch] = out.get(s.batch, 0.0) + s.ms
    return out
