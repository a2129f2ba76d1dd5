"""The port's kernels: their names, the work each call needs, the peaks.

Each count is a function of the shapes one call receives, the formula
`chip_smoke.py` applies to the same kernel (bytes: each input read once,
each output written once; operations: the per-element work of the plain
composition the kernel is held to), so it counts the same work whatever
implements the kernel. A call's bound is the larger of its bytes at the
HBM peak and its operations at the fp32 peak outside the tensor cores.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit).
"""
from __future__ import annotations

from typing import Dict

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# kernel family -> substrings of the CUDA kernel names it launches
FAMILIES = {
    'peaks': ('peaks_tile_kernel', 'peaks_merge_kernel'),
    'topk': ('topk_tile_kernel', 'topk_merge_kernel'),
    'nms_topk': ('nms_topk_kernel',),
    'grouping': ('group_kernel',),
}


def family(kernel_name: str):
    """The family of a kernel name, or None for any other kernel."""
    for fam, parts in FAMILIES.items():
        if any(p in kernel_name for p in parts):
            return fam
    return None


def counts(fam: str, n: int, h: int, w: int, cfg: Dict) -> tuple:
    """(bytes, operations) of one call of kernel family `fam` in the decode
    of `n` images of network-input size h x w, for config `cfg` (its
    keypoints, limbs and decoder settings)."""
    d = cfg['decoder']
    k = d['topk']
    J, L = len(cfg['keypoints']), len(cfg['skeleton'])
    s = 4                                   # the maps' stride
    hs, ws = h // s, w // s
    if fam == 'peaks':                      # (n*J, hs, ws) maps, x4 inside
        b = n * J
        H, W = hs * s, ws * s
        return (b * hs * ws * 4 + b * k * 12,
                b * (7 * H * ws + 16 * H * W + 4 * (H // 2) * (W // 2)))
    if fam == 'topk':                       # (n*J, (h/2)*(w/2)) block maxima
        numel = n * J * (h // 2) * (w // 2)
        return numel * 4 + n * J * k * 8, numel
    if fam == 'nms_topk':                   # (n*J, hs, ws) maps
        numel = n * J * hs * ws
        return numel * 4 + n * J * k * 12, 10 * numel
    if fam == 'grouping':                   # (n, L, k, 13) packed limbs
        M, MP = d.get('capacity', 64), d.get('max_poses', 40)
        passes = L + d.get('settle_passes', 2)
        return (n * L * k * 13 * 4 + n * MP * (J * 6 + 1) * 4 + n * 4,
                n * passes * (k * k + 4 * M * k + M * M * J // 2))
    raise ValueError(f'unknown kernel family {fam}')


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take for the call."""
    return max(n_bytes / PEAK_BYTES, n_ops / PEAK_FP32_FLOPS)
