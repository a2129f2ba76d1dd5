"""Peak finding on the x4 upsampled heatmaps: the CUDA kernel
(`csrc/peaks.cu`) and its plain PyTorch version.

`peaks_topk(maps (B, h, w), k)` returns `(vals, ys, xs)`, each (B, k), the
top-k 2x2 blocks of the NMS'd x`FACTOR` upsampled maps in full-resolution
pixel coordinates: value descending, ties to the lowest flat block index,
first-wins position inside the block. A CUDA tensor launches the kernel,
or raises where k needs more shared memory than a block can have (k is
bounded by that, not by a fixed limit); a CPU tensor takes
`peaks_topk_plain`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..decoder import hmp_nms, topk_channel_blockreduce
from ..resize import phase_taps, upsample2d
from . import _build
from ._build import MAX_SMEM, SELECT_SHARED_BYTES, win_keys

FACTOR = 4       # the kernel's compiled upsampling factor
MAX_TAPS = 5


def smem_bytes(k: int) -> int:
    """Shared memory of the merge launch at k, the only launch whose bytes
    grow with k, as `og_peaks_smem_bytes` in `csrc/peaks.cu` counts it: its
    selection scratch and its k winners (8 bytes a key) and
    og::SelectShared."""
    return SELECT_SHARED_BYTES + 8 * (win_keys(k) + k)


def peaks_topk_plain(maps: torch.Tensor, k: int, method: str = 'bicubic'):
    """upsample2d + hmp_nms + topk_channel_blockreduce on (B, h, w)."""
    up = upsample2d(maps.float()[..., None], FACTOR, method)   # (B, H, W, 1)
    scores, _, ys, xs = topk_channel_blockreduce(hmp_nms(up), k)
    return scores[:, 0], ys[:, 0], xs[:, 0]


def _tap_arrays(method: str):
    taps = phase_taps(FACTOR, method)
    n = np.zeros(FACTOR, np.int32)
    off = np.zeros((FACTOR, MAX_TAPS), np.int32)
    w = np.zeros((FACTOR, MAX_TAPS), np.float32)
    for p, row in enumerate(taps):
        if len(row) > MAX_TAPS or any(abs(o) > 2 for o, _ in row):
            raise ValueError(f'{method} taps exceed the kernel tile halo')
        n[p] = len(row)
        for t, (o, wt) in enumerate(row):
            off[p, t], w[p, t] = o, wt
    return n, off, w


def peaks_topk(maps: torch.Tensor, k: int, method: str = 'bicubic'):
    if not maps.is_cuda:
        return peaks_topk_plain(maps, k, method)
    if maps.dim() != 3:
        raise ValueError(f'maps must be (B, h, w), got {tuple(maps.shape)}')
    b, h, w = maps.shape
    if b == 0:
        raise ValueError('peaks kernel: no maps')
    if not 0 < k <= (2 * h) * (2 * w):
        raise ValueError(f'k={k} outside 1..{4 * h * w} blocks')
    if smem_bytes(k) > MAX_SMEM:
        raise ValueError(f'peaks kernel: k={k} needs {smem_bytes(k)} bytes of '
                         f'shared memory, over the {MAX_SMEM} a block can have')
    maps = maps.float().contiguous()
    lib = _build.library('peaks')
    tiles = lib.og_peaks_tiles(h, w)
    cand = torch.empty(b * tiles * k, dtype=torch.int64, device=maps.device)
    vals = torch.empty((b, k), dtype=torch.float32, device=maps.device)
    ys = torch.empty((b, k), dtype=torch.int32, device=maps.device)
    xs = torch.empty((b, k), dtype=torch.int32, device=maps.device)
    n, off, w_tab = _tap_arrays(method)
    with torch.cuda.device(maps.device):
        code = lib.og_peaks_topk(
            maps.data_ptr(), b, h, w, k, n.ctypes.data, off.ctypes.data,
            w_tab.ctypes.data, cand.data_ptr(), vals.data_ptr(),
            ys.data_ptr(), xs.data_ptr(),
            torch.cuda.current_stream(maps.device).cuda_stream)
    _build.check(code, 'peaks kernel launch')
    peaks_topk.launches += 1
    return vals, ys.long(), xs.long()


peaks_topk.launches = 0
