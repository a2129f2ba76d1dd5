"""Pose decoding: flip-test merge, peak finding on the x4 bicubic heatmaps,
limb collection along the guiding offsets, greedy grouping.

Port of the JAX package's `PostProcessor` for the upsampled decode path
(`upsampled_decode=True`); the stride-resolution branch is not ported yet.
Peaks go through `ops/cuda/peaks.py` and grouping through
`ops/cuda/grouping.py`: the CUDA kernels for CUDA tensors, their plain
versions for CPU tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config.defaults import DecoderConfig, SkeletonConfig
from ..ops import decoder as dec_ops
from ..ops.cuda.grouping import group_skeletons
from ..ops.cuda.peaks import FACTOR as PEAKS_FACTOR


@dataclasses.dataclass(frozen=True)
class PostProcessor:
    skeleton: SkeletonConfig = dataclasses.field(
        default_factory=SkeletonConfig)
    cfg: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)

    def __post_init__(self):
        if not self.cfg.upsampled_decode:
            raise NotImplementedError(
                'stride-resolution decode is not ported yet')
        if self.cfg.scored_offset:
            raise NotImplementedError('scored_offset is not ported yet')
        if self.cfg.nms_kernel != 3:
            raise NotImplementedError('the peaks kernel has a 3x3 NMS')
        if self.cfg.stride != PEAKS_FACTOR:
            raise NotImplementedError(
                f'the peaks kernel upsamples by {PEAKS_FACTOR}, the maps '
                f'have stride {self.cfg.stride}')
        jf, jt = np.asarray(self.skeleton.skeleton, dtype=np.int64).T
        limb_flip, reserve = self.skeleton.offset_flip_indices()
        object.__setattr__(self, '_jf', jf)
        object.__setattr__(self, '_jt', jt)
        object.__setattr__(self, '_kp_flip',
                           self.skeleton.heatmap_flip_indices().tolist())
        object.__setattr__(self, '_limb_flip', limb_flip.tolist())
        object.__setattr__(self, '_reserve', reserve.tolist())

    def select_stage(self, preds: Dict[str, List]) -> Dict[str, Optional[torch.Tensor]]:
        """Pick one stack's maps."""
        stage = self.cfg.feat_stage
        return {k: preds[k][stage] for k in ('hmp', 'jomp', 'omp', 'scmp')}

    def flip_merge(self, maps: Dict[str, Optional[torch.Tensor]]):
        """Merge a flip-test doubled batch [originals; W-flipped inputs]:
        flipped maps are un-flipped and channel-permuted, offsets also
        negate x and permute limbs; direction-reversed limbs (`reserve`)
        keep the original prediction only."""
        hmp = maps['hmp']
        n2 = hmp.shape[0]
        n = n2 // 2
        kp_flip = self._kp_flip

        def unflip(x):
            return torch.flip(x[n:], dims=(2,))

        out = {'hmp': (hmp[:n] + unflip(hmp)[..., kp_flip]) / 2}
        if maps['jomp'] is not None:
            fj = unflip(maps['jomp']).clone()
            fj[..., 0] *= -1.0
            out['jomp'] = (maps['jomp'][:n] + fj) / 2
        else:
            out['jomp'] = None

        off = maps['omp']
        h, w = off.shape[1:3]
        L = off.shape[-1] // 2
        off5 = off.reshape(n2, h, w, L, 2)
        orig = off5[:n]
        flip = torch.flip(off5[n:], dims=(2,)).clone()
        flip[..., 0] *= -1.0
        flip = flip[..., self._limb_flip, :]
        r = self._reserve
        if self.cfg.cat_flip_offs:
            cat = torch.cat([orig, flip], dim=-1)              # (N, h, w, L, 4)
            if r:
                cat[..., r, 2:4] = orig[..., r, :]
            out['omp'] = cat.reshape(n, h, w, 4 * L)
        else:
            merged = (orig + flip) / 2
            if r:
                merged[..., r, :] = orig[..., r, :]
            out['omp'] = merged.reshape(n, h, w, 2 * L)

        if maps['scmp'] is not None:
            fs = unflip(maps['scmp'])[..., kp_flip]
            out['scmp'] = (maps['scmp'][:n] + fs) / 2
        else:
            out['scmp'] = None
        return out

    def decode_packed_limbs(self, preds, flip_test: bool = False):
        """preds -> (N, L, K, 13) packed candidate limbs."""
        maps = self.select_stage(preds)
        if flip_test:
            maps = self.flip_merge(maps)
        cfg = self.cfg
        jomp = maps['jomp'] if cfg.use_jitter_offset else None
        limbs = dec_ops.collect_limbs_peak_fused(
            maps['hmp'], maps['omp'], self._jf, self._jt, cfg,
            jomps4=jomp, scmps4=maps['scmp'])
        return dec_ops.pack_limbs(limbs)

    def decode_body(self, preds, flip_test: bool = False):
        """preds (PoseNet output) -> (poses, scores, counts); poses are
        (N, max_poses, J, 6) in network-input pixel coordinates."""
        packed = self.decode_packed_limbs(preds, flip_test)
        skeleton = tuple(zip(self._jf.tolist(), self._jt.tolist()))
        return group_skeletons(packed, skeleton, self.cfg,
                               n_keypoints=self.skeleton.n_keypoints,
                               capacity=self.cfg.capacity)
