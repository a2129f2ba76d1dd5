"""Greedy skeleton grouping: the CUDA kernel (`csrc/grouping.cu`) and its
plain PyTorch version (`ops/grouping.py`).

`group_skeletons(packed (N, L, K, 13), skeleton, cfg)` returns
`(poses (N, max_poses, J, 6), scores (N, max_poses), counts (N,) int32)`. A
CUDA tensor launches the kernel, one CTA per image, or raises when the shapes
need more shared memory than a block can have; a CPU tensor takes the plain
version.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from ...config.defaults import DecoderConfig
from ..grouping import group_skeletons as group_skeletons_plain
from . import _build
from ._build import MAX_SMEM


def smem_bytes(K: int, J: int, M: int, L: int) -> int:
    """Shared memory of one CTA of the kernel: `smem_bytes` in
    `csrc/grouping.cu`, term for term. The state (M, J, 6), the index copy
    (M, J | 1), two candidate buffers (K, 13), the skeleton (L, 2), four
    per-row arrays, two of a word per candidate, and a bit per candidate
    for each of the 32 warps; four bytes each."""
    return 4 * (M * J * 6 + M * (J | 1) + 2 * K * 13 + 2 * L + 4 * M + 2 * K
                + 32 * ((K + 31) // 32))


_skeletons: Dict[Tuple[torch.device, tuple], torch.Tensor] = {}


def _skeleton_on(dev: torch.device, skeleton: Sequence) -> torch.Tensor:
    """The (L, 2) int32 skeleton on `dev`, copied there once: a copy per
    call from pageable host memory would wait for the stream's queued work."""
    key = (dev, tuple(map(tuple, skeleton)))
    if key not in _skeletons:
        _skeletons[key] = torch.tensor(key[1], dtype=torch.int32, device=dev)
    return _skeletons[key]


def check_shapes(K: int, J: int, M: int, L: int, max_poses: int,
                 sort_dim: int) -> None:
    """Raise ValueError, naming the shapes, where the kernel cannot run:
    max_poses over the capacity, or more shared memory than a block has."""
    if not (M > 0 and K > 0 and max_poses <= M and sort_dim in range(6)):
        raise ValueError(f'grouping kernel: capacity {M}, top-k {K}, '
                         f'max_poses {max_poses}, sort_dim {sort_dim}: needs '
                         f'0 < max_poses <= capacity, 0 <= sort_dim < 6')
    need = smem_bytes(K, J, M, L)
    if need > MAX_SMEM:
        raise ValueError(f'grouping kernel: capacity {M}, top-k {K}, {J} '
                         f'keypoints, {L} limbs need {need} bytes of shared '
                         f'memory, over the {MAX_SMEM} a block can have')


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
    check_shapes(K, n_keypoints, capacity, L, cfg.max_poses, cfg.sort_dim)
    dev = packed_limbs.device
    x = packed_limbs.float().contiguous()
    skel = _skeleton_on(dev, skeleton)
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
