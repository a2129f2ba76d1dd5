"""Pose decoding: flip-test merge, peak finding, limb collection along the
guiding offsets, greedy grouping.

Port of the JAX package's `PostProcessor`, routed as it routes on the TPU:
- `upsampled_decode=True` with square maps and a 3x3 NMS: the fused peaks
  kernel (`ops/cuda/peaks.py`) on the stride-4 heatmaps;
- `upsampled_decode=True` otherwise (fixed-height eval's non-square maps,
  or `nms_kernel != 3`): `upsample2d` + `hmp_nms` in PyTorch, then the
  block-max top-k kernel (`ops/cuda/topk.py`);
- `upsampled_decode=False`: decode at stride resolution through the fused
  NMS + top-k kernel (`ops/cuda/nms_topk.py`, or `joint_dets` for
  `nms_kernel != 3`), then map cells to input pixels.
Grouping goes through `ops/cuda/grouping.py`. Each wrapper launches its CUDA
kernel for a CUDA tensor and takes its plain version for a CPU tensor; the
call sites look the wrappers up on their modules at call time.
`decode_body` records its stages in `utils/profiling.RECORDER`:
`decode.merge` (flip test), `decode.limbs` (peaks, limb collection,
packing) and `decode.group`. The index lists it reads on the device (flip
permutations, limb ends, channel groups) are copied there once
(`ops/constants.py`), and the tap weights are Python floats, so a warm
decode issues its launches without a copy from the host: nothing in it
waits for the forward before it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config.defaults import DecoderConfig, SkeletonConfig
from ..ops import decoder as dec_ops
from ..ops.constants import on_device
from ..ops.cuda import grouping as cuda_grouping
from ..ops.cuda.peaks import FACTOR as PEAKS_FACTOR
from ..ops.resize import upsample2d
from ..utils.profiling import RECORDER


@dataclasses.dataclass(frozen=True)
class PostProcessor:
    skeleton: SkeletonConfig = dataclasses.field(
        default_factory=SkeletonConfig)
    cfg: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)

    def __post_init__(self):
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
        dev = hmp.device
        kp_flip = on_device(self._kp_flip, dev)

        def unflip(x):
            return torch.flip(x[n:], dims=(2,))

        out = {'hmp': (hmp[:n] + unflip(hmp).index_select(-1, kp_flip)) / 2}
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
        flip = flip.index_select(-2, on_device(self._limb_flip, dev))
        r = on_device(self._reserve, dev) if self._reserve else None
        if self.cfg.cat_flip_offs:
            cat = torch.cat([orig, flip], dim=-1)              # (N, h, w, L, 4)
            if r is not None:
                cat[..., 2:4].index_copy_(-2, r, orig.index_select(-2, r))
            out['omp'] = cat.reshape(n, h, w, 4 * L)
        else:
            merged = (orig + flip) / 2
            if r is not None:
                merged.index_copy_(-2, r, orig.index_select(-2, r))
            out['omp'] = merged.reshape(n, h, w, 2 * L)

        if maps['scmp'] is not None:
            fs = unflip(maps['scmp']).index_select(-1, kp_flip)
            out['scmp'] = (maps['scmp'][:n] + fs) / 2
        else:
            out['scmp'] = None
        return out

    def decode_packed_limbs(self, preds, flip_test: bool = False):
        """preds -> (N, L, K, 13) packed candidate limbs."""
        maps = self.select_stage(preds)
        if flip_test:
            maps = self.flip_merge(maps)
        return self.packed_limbs(maps)

    def packed_limbs(self, maps):
        """One stack's (merged) maps -> (N, L, K, 13) packed limbs."""
        cfg = self.cfg
        s = cfg.stride
        hmp, omp, scmp = maps['hmp'], maps['omp'], maps['scmp']
        jomp = maps['jomp'] if cfg.use_jitter_offset else None
        if cfg.scored_offset:
            omp = dec_ops.scored_offset(hmp, omp, self._jf, kernel_size=3)
        if cfg.upsampled_decode:
            if hmp.shape[1] == hmp.shape[2] and cfg.nms_kernel == 3:
                limbs = dec_ops.collect_limbs_peak_fused(
                    hmp, omp, self._jf, self._jt, cfg, jomps4=jomp,
                    scmps4=scmp)
            else:
                limbs = dec_ops.collect_limbs_peak_sampled(
                    upsample2d(hmp, s, cfg.resize_mode), omp, self._jf,
                    self._jt, cfg, jomps4=jomp, scmps4=scmp, stride=s)
            return dec_ops.pack_limbs(limbs)

        limbs = dec_ops.collect_limbs(hmp, omp / float(s), self._jf,
                                      self._jt, cfg, scmps=scmp)
        packed = dec_ops.pack_limbs(limbs)
        # cell -> input pixel (x * s + s/2 - 0.5) for on-image candidates;
        # off-image sentinels stay far negative; lengths scale by s. The
        # columns x1, y1, x2, y2 (0, 1, 3, 4) as one strided view
        coords = packed[..., :6].unflatten(-1, (2, 3))[..., :2]
        coords.copy_(torch.where(coords > -1000.0,
                                 coords * s + (s / 2 - 0.5), coords))
        packed[..., 8:10] *= float(s)
        if jomp is not None:
            packed = self._apply_jitter_lowres(packed, jomp, limbs)
        return packed

    def _apply_jitter_lowres(self, packed, jomp, limbs):
        """Add the jitter offsets (input-pixel units) at the stride-resolution
        candidates' cells."""
        n, h, w, _ = jomp.shape
        L, k = limbs.ind_f.shape[1:]
        page = h * w
        flat = jomp.reshape(n, page, 2)

        def gather(ind):                       # ind (N, L, K) global index
            idx = (ind % page).reshape(n, L * k, 1).expand(n, L * k, 2)
            return flat.gather(1, idx).reshape(n, L, k, 2)

        packed[..., 0:2] += gather(limbs.ind_f)
        packed[..., 3:5] += gather(limbs.ind_t)
        return packed

    def decode_body(self, preds, flip_test: bool = False):
        """preds (PoseNet output) -> (poses, scores, counts); poses are
        (N, max_poses, J, 6) in network-input pixel coordinates."""
        rec = RECORDER
        maps = self.select_stage(preds)
        if flip_test:
            stage = rec.start('decode.merge')
            maps = self.flip_merge(maps)
            rec.stop(stage)
        stage = rec.start('decode.limbs')
        packed = self.packed_limbs(maps)
        rec.stop(stage)
        stage = rec.start('decode.group')
        skeleton = tuple(zip(self._jf.tolist(), self._jt.tolist()))
        out = cuda_grouping.group_skeletons(
            packed, skeleton, self.cfg, n_keypoints=self.skeleton.n_keypoints,
            capacity=self.cfg.capacity)
        rec.stop(stage)
        return out
