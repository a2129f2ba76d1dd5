"""Dataclass configuration for the inference and evaluation paths of the
PyTorch port.

Same fields and defaults as the JAX package's `config/defaults.py` for the
configs inference, evaluation and the GT encoder read. Dropped here, because they only steer TPU code:
`ModelConfig.stem_s2d` (space-to-depth stem), `ModelConfig.remat`,
`DecoderConfig.peaks_map_batch` (Pallas map batching) and
`DecoderConfig.pallas_grouping` (the port always takes its CUDA kernels on a
CUDA tensor and the plain PyTorch versions on a CPU tensor).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from . import coco


@dataclasses.dataclass(frozen=True)
class SkeletonConfig:
    """Keypoint taxonomy + limb topology bundle."""
    keypoints: tuple = coco.COCO_KEYPOINTS
    sigmas: tuple = coco.COCO_PERSON_SIGMAS
    skeleton: tuple = coco.COCO_PERSON_SKELETON
    hflip: tuple = tuple(sorted(coco.HFLIP.items()))

    @property
    def n_keypoints(self) -> int:
        return len(self.keypoints)

    @property
    def n_limbs(self) -> int:
        return len(self.skeleton)

    def heatmap_flip_indices(self):
        return coco.heatmap_hflip(self.keypoints, dict(self.hflip))

    def offset_flip_indices(self):
        return coco.offset_hflip(self.keypoints, self.skeleton,
                                 dict(self.hflip))


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Ground-truth rendering configuration."""
    stride: int = 4
    sigma: float = 7.0
    gaussian_clip: float = 0.01       # responses below this are zeroed
    fill_jitter_size: int = 3         # window diameter for jitter-offset fill
    fill_scale_size: int = 7          # window diameter for guiding-offset/scale fill
    min_jscale: float = 1.0           # keypoint scales below this become NaN labels
    include_background: bool = True
    include_jitter_offset: bool = True
    include_scale: bool = True
    max_persons: int = 32             # fixed-shape padding for annotations per image
    mask_miss_threshold: float = 0.7  # bool threshold after mask downscale


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Decoding / grouping configuration."""
    stride: int = 4                   # feature stride of hmp/omp heads
    topk: int = 48                    # candidate keypoints per channel
    thre_hmp: float = 0.06            # low-response keypoints pushed off-image
    min_len: float = 0.5              # clamp for limb length in scoring
    dist_max: float = 20.0            # max guiding-offset error (pixels)
    use_scale: bool = True            # use inferred keypoint scales in dist gate
    use_jitter_offset: bool = True    # refine coordinates with jitter offsets
    default_scale: float = 4.0        # keypoint scale when scmps are absent
    person_thre: float = 0.06         # final instance score threshold
    sort_dim: int = 2                 # 2 = sort poses by keypoint score, 4 = limb score
    resize_mode: str = 'bicubic'      # heatmap upsampling filter
    feat_stage: int = -1              # which stack's predictions to decode
    nms_kernel: int = 3               # peak NMS window
    max_poses: int = 40               # fixed-shape capacity of the grouped output
    capacity: int = 64                # skeleton rows held during grouping
    upsampled_decode: bool = True     # decode at input resolution
    scored_offset: bool = False
    # flip-test merge keeps both offset vectors and pairs keypoints by the
    # 4-D distance |[g1;g2] - [t;t]|
    cat_flip_offs: bool = False
    guid_jitter_refine: bool = False
    # merge-only passes after the last limb iteration
    settle_passes: int = 2


@dataclasses.dataclass(frozen=True)
class HeadsConfig:
    """Head-net channel configuration."""
    n_keypoints: int = 17
    n_limbs: int = 19
    include_background: bool = True
    include_jitter_offset: bool = True
    include_spread: bool = False
    include_scale: bool = True
    tower: bool = False
    tower_dim: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Backbone + heads configuration."""
    basenet: str = 'hourglass104'     # 'hourglass104' | 'hourglass52'
    n_stacks: int = 2
    cnv_dim: int = 256
    hg_order: int = 5
    dims: Sequence[int] = (256, 256, 384, 384, 384, 512)
    modules: Sequence[int] = (2, 2, 2, 2, 2, 4)
    heads: HeadsConfig = dataclasses.field(default_factory=HeadsConfig)
    # bf16 convolutions with fp32 BatchNorm statistics and fp32 heads
    compute_dtype: str = 'bfloat16'
    param_dtype: str = 'float32'
    bn_momentum: float = 0.9


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Evaluation / serving preprocessing."""
    long_edge: int = 640
    fixed_height: bool = False
    max_stride: int = 128
    width_bucket: int = 256
    flip_test: bool = True
    batch_size: int = 8
    cat_flip_offsets: bool = False
    io_workers: int = 4
