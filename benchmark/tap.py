"""Copies of what the timed path produced, taken inside the window.

`Tap` records, for the calls it selects, the model's input (turned back
into uint8 pixels), the maps of the stack the decoder reads (heatmaps,
jitter, guiding offsets, scales) and the decoder's output (poses, scores,
counts). It hooks the model's forward and wraps the PostProcessor's
`decode_body` on the instance, and copies to pinned host memory without
a synchronisation, so the window's overlap of host and device stays as
it is; `warm` makes the same copies once at set-up and drops them, so
that the window finds its pinned blocks in PyTorch's cache and allocates
none. The check reads the copies after the window: the forward is held
to the reference's forward on the same scenes, and the reference decodes
the program's own maps, stage by stage.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch

MAP_KEYS = ('hmp', 'jomp', 'omp', 'scmp')


def _stash(t: torch.Tensor) -> torch.Tensor:
    if t.device.type != 'cuda':
        return t.detach().clone()
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t.detach(), non_blocking=True)
    return buf


class Tap:
    """`select(n)` says whether decode call n (counted from `arm()`) is
    copied; `calls` holds one dict a copied call."""

    def __init__(self, model, postprocessor, select: Callable[[int], bool],
                 mean, std, flip: bool):
        self.select = select
        self.armed, self.n = False, 0
        self.calls: List[Dict] = []
        self._pending = None
        scale = {}

        def hook(_, args, preds):
            if not (self.armed and self.select(self.n)):
                return
            x = args[0]
            if x.device not in scale:
                scale[x.device] = tuple(
                    torch.tensor(v, dtype=torch.float32, device=x.device)
                    for v in (mean, std))
            m, s = scale[x.device]
            if flip:
                x = x[:x.shape[0] // 2]
            u8 = ((x.float() * s + m) * 255.0)
            u8 = u8.round().clamp(0, 255).to(torch.uint8)
            maps = {k: preds[k][-1] for k in MAP_KEYS if preds.get(k)}
            self._pending = {
                'u8': _stash(u8),
                'maps': {k: _stash(v) for k, v in maps.items()
                         if v is not None}}

        self._hook = model.register_forward_hook(hook)
        original = postprocessor.decode_body

        def decode_body(preds, flip_test=False):
            out = original(preds, flip_test=flip_test)
            if self.armed:
                if self.select(self.n) and self._pending is not None:
                    rec = self._pending
                    rec['poses'], rec['scores'], rec['counts'] = (
                        _stash(o) for o in out)
                    self.calls.append(rec)
                self._pending = None
                self.n += 1
            return out

        object.__setattr__(postprocessor, 'decode_body', decode_body)

    def arm(self) -> None:
        self.armed, self.n = True, 0

    def warm(self, run) -> int:
        """Copy every call of `run()` and drop the copies; returns the
        number of decode calls it made."""
        select, self.select = self.select, (lambda n: True)
        self.arm()
        try:
            run()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        finally:
            self.select, self.armed = select, False
        self.calls.clear()
        return self.n

    def disarm(self) -> None:
        self.armed = False
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._hook.remove()
