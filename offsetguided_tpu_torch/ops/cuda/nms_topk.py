"""Fused 3x3 peak NMS + top-k per map: the CUDA kernel (`csrc/nms_topk.cu`)
and its plain PyTorch version.

`nms_topk(maps (M, h, w), k)` returns `(vals (M, k) float32, inds (M, k)
int64)`: the top-k of `hmp_nms(maps)` over the flat row-major h*w index,
values descending, ties to the lowest index. A CUDA tensor launches the
kernel (on a contiguous copy where the maps are not contiguous), or raises
where the shapes need more shared memory than a block can have (k is
bounded by that, not by a fixed limit); a CPU tensor takes
`nms_topk_plain`.
"""
from __future__ import annotations

import torch

from ..decoder import hmp_nms, stable_topk
from . import _build

from ._build import MAX_SMEM, SELECT_SHARED_BYTES, win_keys

# as in csrc/nms_topk.cu
BANDS, TILE_FLOATS, MASK_WORDS, SMALL_K = 8, 6144, 256, 32
MAX_COLS = TILE_FLOATS // 3 - 2


def smem_bytes(h: int, w: int, k: int) -> int:
    """Shared memory of one CTA of the kernel: `Layout` in
    `csrc/nms_topk.cu`, term for term, plus og::SelectShared. The positive
    list (a staged tile's cells plus k), the selection's scratch and the
    leader's BANDS lists (of at least SMALL_K keys), 8 bytes a key; the
    staged tile with its halo and the zero-cell mask, 4 bytes a word; and
    16 bytes of counters."""
    rows = -(-h // BANDS)
    tc = min(w, MAX_COLS)
    tr = min(rows, TILE_FLOATS // (tc + 2) - 2)
    keys = tr * tc + k + win_keys(k) + BANDS * max(k, SMALL_K)
    words = (tr + 2) * (tc + 2) + MASK_WORDS
    return SELECT_SHARED_BYTES + 8 * keys + 4 * words + 16


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
    if not 0 < k <= h * w:
        raise ValueError(f'k={k} outside 1..{h * w} cells')
    if m == 0 or h * w >= 2 ** 31:
        raise ValueError(f'nms_topk kernel limits: M > 0, '
                         f'h*w < 2^31; got {tuple(maps.shape)}')
    need = smem_bytes(h, w, k)
    if need > MAX_SMEM:
        raise ValueError(f'nms_topk kernel: ({h}, {w}) maps at k={k} need '
                         f'{need} bytes of shared memory, over the '
                         f'{MAX_SMEM} a block can have')
    maps = maps.float().contiguous()
    dev = maps.device
    vals = torch.empty((m, k), dtype=torch.float32, device=dev)
    inds = torch.empty((m, k), dtype=torch.int64, device=dev)
    lib = _build.library('nms_topk')
    with torch.cuda.device(dev):
        code = lib.og_nms_topk(maps.data_ptr(), m, h, w, k, vals.data_ptr(),
                               inds.data_ptr(),
                               torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, 'nms_topk kernel launch')
    nms_topk.launches += 1
    return vals, inds


nms_topk.launches = 0
