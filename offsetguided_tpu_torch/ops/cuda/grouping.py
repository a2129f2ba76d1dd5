"""Greedy skeleton grouping: the CUDA kernel (`csrc/grouping.cu`) and its
plain PyTorch version (`ops/grouping.py`).

`group_skeletons(packed (N, L, K, 13), skeleton, cfg)` returns
`(poses (N, max_poses, J, 6), scores (N, max_poses), counts (N,) int32)`. A
CUDA tensor launches the kernel, one CTA per image; a CPU tensor takes the
plain version.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ...config.defaults import DecoderConfig
from ..grouping import group_skeletons as group_skeletons_plain
from . import _build

MAX_CAPACITY = 64     # merge masks are 64-bit words
MAX_K = 256           # one thread per candidate in the new-row phase


def group_skeletons(packed_limbs: torch.Tensor, skeleton: Sequence,
                    cfg: DecoderConfig, n_keypoints: int = 17,
                    capacity: int = 64):
    if not packed_limbs.is_cuda:
        return group_skeletons_plain(packed_limbs, skeleton, cfg,
                                     n_keypoints, capacity)
    n, L, K, C = packed_limbs.shape
    if C != 13 or L != len(skeleton):
        raise ValueError(f'packed limbs {tuple(packed_limbs.shape)} do not '
                         f'match a {len(skeleton)}-limb skeleton')
    if not (0 < capacity <= MAX_CAPACITY and 0 < K <= MAX_K
            and cfg.max_poses <= capacity and cfg.sort_dim in range(6)):
        raise ValueError('grouping kernel limits: capacity <= 64, K <= 256, '
                         'max_poses <= capacity')
    dev = packed_limbs.device
    x = packed_limbs.float().contiguous()
    skel = torch.tensor(skeleton, dtype=torch.int32, device=dev).contiguous()
    poses = torch.empty((n, cfg.max_poses, n_keypoints, 6),
                        dtype=torch.float32, device=dev)
    scores = torch.empty((n, cfg.max_poses), dtype=torch.float32, device=dev)
    counts = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return poses, scores, counts
    lib = _build.library('grouping')
    with torch.cuda.device(dev):
        code = lib.og_group_skeletons(
            x.data_ptr(), skel.data_ptr(), n, L, K, n_keypoints, capacity,
            cfg.max_poses, cfg.settle_passes, cfg.sort_dim,
            int(cfg.use_scale), float(cfg.dist_max), float(cfg.person_thre),
            poses.data_ptr(), scores.data_ptr(), counts.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, 'grouping kernel launch')
    group_skeletons.launches += 1
    return poses, scores, counts


group_skeletons.launches = 0
