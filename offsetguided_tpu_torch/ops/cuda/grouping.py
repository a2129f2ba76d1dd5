"""Greedy skeleton grouping: the CUDA kernel (`csrc/grouping.cu`) and its
plain PyTorch version (`ops/grouping.py`).

`group_skeletons(packed (N, L, K, 13), skeleton, cfg)` returns
`(poses (N, max_poses, J, 6), scores (N, max_poses), counts (N,) int32)`
on every device, whatever the capacity: the rows past the kept ones are
zeros with score 0, as in the TPU kernel the CUDA one replaces.
It calls the custom op `offsetguided::group_skeletons` with the skeleton
as a flat list of ints and the decoder settings the grouping reads as
scalars: its CUDA implementation launches the kernel, one CTA per image,
or raises when the shapes need more shared memory than a block can have;
its CPU implementation is the plain version; its fake implementation gives
the output shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

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
    an empty capacity, top-k or output, a sort column past the six, or more
    shared memory than a block has. `max_poses` may pass the capacity: the
    output's ranks from the capacity on are zeros."""
    if not (M > 0 and K > 0 and max_poses > 0 and sort_dim in range(6)):
        raise ValueError(f'grouping kernel: capacity {M}, top-k {K}, '
                         f'max_poses {max_poses}, sort_dim {sort_dim}: needs '
                         f'capacity, top-k and max_poses above 0, '
                         f'0 <= sort_dim < 6')
    need = smem_bytes(K, J, M, L)
    if need > MAX_SMEM:
        raise ValueError(f'grouping kernel: capacity {M}, top-k {K}, {J} '
                         f'keypoints, {L} limbs need {need} bytes of shared '
                         f'memory, over the {MAX_SMEM} a block can have')


def group_skeletons(packed_limbs: torch.Tensor, skeleton: Sequence,
                    cfg: DecoderConfig, n_keypoints: int = 17,
                    capacity: int = 64):
    return _group_op(packed_limbs, [int(j) for pair in skeleton for j in pair],
                     n_keypoints, capacity, cfg.max_poses, cfg.settle_passes,
                     cfg.sort_dim, bool(cfg.use_scale), float(cfg.dist_max),
                     float(cfg.person_thre))


def _pairs(skeleton: List[int]) -> tuple:
    return tuple(zip(skeleton[0::2], skeleton[1::2]))


def _settings(max_poses, settle_passes, sort_dim, use_scale, dist_max,
              person_thre) -> DecoderConfig:
    """The decoder settings the grouping reads, as a `DecoderConfig`."""
    return dataclasses.replace(
        DecoderConfig(), max_poses=max_poses, settle_passes=settle_passes,
        sort_dim=sort_dim, use_scale=use_scale, dist_max=dist_max,
        person_thre=person_thre)


def _group_cuda(packed_limbs: torch.Tensor, skeleton: List[int],
                n_keypoints: int, capacity: int, max_poses: int,
                settle_passes: int, sort_dim: int, use_scale: bool,
                dist_max: float, person_thre: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The op's CUDA implementation: launches the kernel."""
    n, L, K, C = packed_limbs.shape
    if C != 13 or 2 * L != len(skeleton):
        raise ValueError(f'packed limbs {tuple(packed_limbs.shape)} do not '
                         f'match a {len(skeleton) // 2}-limb skeleton')
    check_shapes(K, n_keypoints, capacity, L, max_poses, sort_dim)
    dev = packed_limbs.device
    x = packed_limbs.float().contiguous()
    skel = _skeleton_on(dev, _pairs(skeleton))
    poses = torch.empty((n, max_poses, n_keypoints, 6),
                        dtype=torch.float32, device=dev)
    scores = torch.empty((n, max_poses), dtype=torch.float32, device=dev)
    counts = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return poses, scores, counts
    lib = _build.library('grouping')
    with torch.cuda.device(dev):
        code = lib.og_group_skeletons(
            x.data_ptr(), skel.data_ptr(), n, L, K, n_keypoints, capacity,
            max_poses, settle_passes, sort_dim, int(use_scale),
            float(dist_max), float(person_thre), poses.data_ptr(),
            scores.data_ptr(), counts.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, 'grouping kernel launch')
    group_skeletons.launches += 1
    return poses, scores, counts


_group_op = torch.library.custom_op(
    'offsetguided::group_skeletons', _group_cuda, mutates_args=(),
    device_types='cuda')


@_group_op.register_kernel('cpu')
def _(packed_limbs, skeleton, n_keypoints, capacity, max_poses,
      settle_passes, sort_dim, use_scale, dist_max, person_thre):
    # dense outputs: the strides the fake implementation gives
    out = group_skeletons_plain(
        packed_limbs, _pairs(skeleton),
        _settings(max_poses, settle_passes, sort_dim, use_scale, dist_max,
                  person_thre), n_keypoints, capacity)
    return tuple(t.contiguous() for t in out)


@_group_op.register_fake
def _(packed_limbs, skeleton, n_keypoints, capacity, max_poses,
      settle_passes, sort_dim, use_scale, dist_max, person_thre):
    n = packed_limbs.shape[0]
    return (packed_limbs.new_empty((n, max_poses, n_keypoints, 6),
                                   dtype=torch.float32),
            packed_limbs.new_empty((n, max_poses), dtype=torch.float32),
            packed_limbs.new_empty((n,), dtype=torch.int32))


group_skeletons.launches = 0
