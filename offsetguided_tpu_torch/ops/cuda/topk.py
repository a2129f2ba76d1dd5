"""Exact top-k over the last axis: the CUDA kernel (`csrc/topk.cu`) and its
plain PyTorch version.

`topk(x (M, n), k)` returns `(vals (M, k) float32, inds (M, k) int64)`:
values descending, ties to the lowest index, distinct indices (the order of
`lax.top_k`, except that -0.0 ties with +0.0). A CUDA tensor launches the
kernel, or raises where k needs more shared memory than a block can have (k
is bounded by that, not by a fixed limit); a CPU tensor takes `topk_plain`.
"""
from __future__ import annotations

import torch

from ..decoder import stable_topk
from . import _build
from ._build import MAX_SMEM, SELECT_SHARED_BYTES, win_keys

TILE = 4096      # elements a tile CTA selects over, as in csrc/topk.cu


def smem_bytes(k: int) -> int:
    """Shared memory of the larger of the kernel's two launches at k, as
    `og_topk_smem_bytes` in `csrc/topk.cu` counts it: the tile's high words
    (4 bytes an element) and its selection scratch for min(k, TILE) keys;
    the merge's scratch and its k winners (8 bytes a key); each with
    og::SelectShared."""
    tile = TILE * 4 + 8 * win_keys(min(k, TILE))
    merge = 8 * (win_keys(k) + k)
    return SELECT_SHARED_BYTES + max(tile, merge)


def topk_plain(x: torch.Tensor, k: int):
    """`stable_topk` on (M, n)."""
    return stable_topk(x.float(), k)


def topk(x: torch.Tensor, k: int):
    if not x.is_cuda:
        return topk_plain(x, k)
    if x.dim() != 2:
        raise ValueError(f'x must be (M, n), got {tuple(x.shape)}')
    m, n = x.shape
    if not 0 < k <= n:
        raise ValueError(f'k={k} outside 1..n={n}')
    if smem_bytes(k) > MAX_SMEM:
        raise ValueError(f'topk kernel: k={k} needs {smem_bytes(k)} bytes of '
                         f'shared memory, over the {MAX_SMEM} a block can have')
    if m == 0 or n >= 2 ** 31:
        raise ValueError(f'topk kernel limits: M > 0, n < 2^31; '
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
