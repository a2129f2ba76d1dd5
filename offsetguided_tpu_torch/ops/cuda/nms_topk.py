"""Fused 3x3 peak NMS + top-k per map: the CUDA kernel (`csrc/nms_topk.cu`)
and its plain PyTorch version.

`nms_topk(maps (M, h, w), k)` returns `(vals (M, k) float32, inds (M, k)
int64)`: the top-k of `hmp_nms(maps)` over the flat row-major h*w index,
values descending, ties to the lowest index. A CUDA tensor launches the
kernel; a CPU tensor takes `nms_topk_plain`.
"""
from __future__ import annotations

import torch

from ..decoder import hmp_nms, stable_topk
from . import _build

MAX_K = 512      # the merge kernel's shared-memory lists


def nms_topk_plain(maps: torch.Tensor, k: int):
    """`hmp_nms` (3x3) then `stable_topk` over the flat h*w index."""
    m = maps.shape[0]
    nmsed = hmp_nms(maps.float()[..., None])[..., 0]
    return stable_topk(nmsed.reshape(m, -1), k)


def nms_topk(maps: torch.Tensor, k: int):
    if not maps.is_cuda:
        return nms_topk_plain(maps, k)
    if maps.dim() != 3:
        raise ValueError(f'maps must be (M, h, w), got {tuple(maps.shape)}')
    m, h, w = maps.shape
    if not 0 < k <= min(MAX_K, h * w):
        raise ValueError(f'k={k} outside 1..min({MAX_K}, {h * w} cells)')
    if not 0 < m <= 65535 or h * w >= 2 ** 31:
        raise ValueError(f'nms_topk kernel grid limits: 0 < M <= 65535, '
                         f'h*w < 2^31; got {tuple(maps.shape)}')
    maps = maps.float().contiguous()
    lib = _build.library('nms_topk')
    cand = torch.empty(m * lib.og_nms_topk_tiles(h, w) * k, dtype=torch.int64,
                       device=maps.device)
    vals = torch.empty((m, k), dtype=torch.float32, device=maps.device)
    inds = torch.empty((m, k), dtype=torch.int32, device=maps.device)
    with torch.cuda.device(maps.device):
        code = lib.og_nms_topk(
            maps.data_ptr(), m, h, w, k, cand.data_ptr(), vals.data_ptr(),
            inds.data_ptr(), torch.cuda.current_stream(maps.device).cuda_stream)
    _build.check(code, 'nms_topk kernel launch')
    nms_topk.launches += 1
    return vals, inds.long()


nms_topk.launches = 0
