"""Exact top-k over the last axis: the CUDA kernel (`csrc/topk.cu`) and its
plain PyTorch version.

`topk(x (M, n), k)` returns `(vals (M, k) float32, inds (M, k) int64)`:
values descending, ties to the lowest index, distinct indices (the order of
`lax.top_k`, except that -0.0 ties with +0.0). A CUDA tensor launches the
kernel; a CPU tensor takes `topk_plain`.
"""
from __future__ import annotations

import torch

from ..decoder import stable_topk
from . import _build

MAX_K = 512      # the merge kernel's shared-memory lists


def topk_plain(x: torch.Tensor, k: int):
    """`stable_topk` on (M, n)."""
    return stable_topk(x.float(), k)


def topk(x: torch.Tensor, k: int):
    if not x.is_cuda:
        return topk_plain(x, k)
    if x.dim() != 2:
        raise ValueError(f'x must be (M, n), got {tuple(x.shape)}')
    m, n = x.shape
    if not 0 < k <= min(MAX_K, n):
        raise ValueError(f'k={k} outside 1..min({MAX_K}, n={n})')
    if not 0 < m <= 65535 or n >= 2 ** 31:
        raise ValueError(f'topk kernel grid limits: 0 < M <= 65535, n < 2^31; '
                         f'got {tuple(x.shape)}')
    x = x.float().contiguous()
    lib = _build.library('topk')
    cand = torch.empty(m * lib.og_topk_tiles(n) * k, dtype=torch.int64,
                       device=x.device)
    vals = torch.empty((m, k), dtype=torch.float32, device=x.device)
    inds = torch.empty((m, k), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.og_topk(x.data_ptr(), m, n, k, cand.data_ptr(),
                           vals.data_ptr(), inds.data_ptr(),
                           torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, 'topk kernel launch')
    topk.launches += 1
    return vals, inds.long()


topk.launches = 0
