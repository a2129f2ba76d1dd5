"""Dataclass configuration for the PyTorch port: inference, evaluation, the
GT encoder, losses, optimization and augmentation.

Same fields and defaults as the JAX package's `config/defaults.py`. Dropped
here, because they only steer TPU code: `ModelConfig.stem_s2d`
(space-to-depth stem), `DecoderConfig.peaks_map_batch` (Pallas map
batching) and `DecoderConfig.pallas_grouping` (the port always takes its
CUDA kernels on a CUDA tensor and the plain PyTorch versions on a CPU
tensor).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from . import coco, crowdpose


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

    @classmethod
    def coco(cls, n_limbs: int = 19) -> 'SkeletonConfig':
        return cls(skeleton=coco.SKELETONS_BY_SIZE[n_limbs])

    @classmethod
    def crowdpose(cls) -> 'SkeletonConfig':
        return cls(keypoints=crowdpose.CROWDPOSE_KEYPOINTS,
                   sigmas=crowdpose.CROWDPOSE_SIGMAS,
                   skeleton=crowdpose.CROWDPOSE_PERSON_SKELETON,
                   hflip=tuple(sorted(crowdpose.CROWDPOSE_HFLIP.items())))

    @classmethod
    def for_dataset(cls, dataset: str, n_limbs: int = 19) -> 'SkeletonConfig':
        """The skeleton of a CLI's `--dataset`: 'crowdpose', or 'coco' with
        `n_limbs` guiding-offset limbs."""
        return cls.crowdpose() if dataset == 'crowdpose' else cls.coco(n_limbs)


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
    # 'hourglass104' | 'hourglass52' | 'hourglass4stage' (the 4-stage net
    # has fixed widths: n_stacks and remat apply, the hourglass104 fields
    # below do not)
    basenet: str = 'hourglass104'
    n_stacks: int = 2
    cnv_dim: int = 256
    hg_order: int = 5
    dims: Sequence[int] = (256, 256, 384, 384, 384, 512)
    modules: Sequence[int] = (2, 2, 2, 2, 2, 4)
    heads: HeadsConfig = dataclasses.field(default_factory=HeadsConfig)
    # bf16 convolutions with fp32 BatchNorm statistics and fp32 heads
    compute_dtype: str = 'bfloat16'
    param_dtype: str = 'float32'
    # JAX convention: running = momentum * running + (1 - momentum) * batch
    bn_momentum: float = 0.9
    # recompute each hourglass stack in the backward instead of storing its
    # activations (torch.utils.checkpoint): ~1 extra forward per stack for
    # ~n_stacks x less activation memory
    remat: bool = False


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss selection and weighting. `lambdas` weight order: [hmp,
    background, jitter-offset, offset, scale]. Defaults are the training
    recipe: focal-L2 (gamma 2) + instance-normalized offset L1 + scale L1
    with lambdas 1 0 0 10000 10 and sqrt-rescaled offset losses."""
    heatmap_loss: str = 'focal_l2'
    jitter_loss: str = 'offset_l1'
    offset_loss: str = 'offset_instance_l1'
    scale_loss: str = 'scale_l1'
    lambdas: Sequence[float] = (1.0, 0.0, 0.0, 10000.0, 10.0)
    stack_weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0)
    ftao: float = 0.01                # focal-L2 fore/background threshold (TAU)
    fgamma: float = 2.0               # focal-L2 scaling order (GAMMA)
    offset_margin: float = 1e-5       # per-element losses below MARGIN are ignored
    scale_margin: float = 0.1         # MARGIN2 for scale loss
    sqrt_re: bool = True              # sqrt-rescale offset losses


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization recipe."""
    optimizer: str = 'adam'           # 'adam' | 'sgd'
    learning_rate: float = 1.25e-4    # scaled by data-parallel world size
    momentum: float = 0.9
    weight_decay: float = 0.0
    # Adam moment-state dtype: 'float32' or 'bfloat16' (moments round-trip
    # through fp32 inside the update, so only their storage loses precision)
    opt_state_dtype: str = 'float32'
    warmup_epochs: int = 0
    lr_drop_epochs: Sequence[int] = (60, 78, 92, 105)
    lr_drop_factor: float = 0.2
    epochs: int = 120
    batch_size: int = 16              # global batch
    square_length: int = 512
    loss_explosion_guard: float = 1e8  # skip batches with larger loss
    checkpoint_dir: str = 'checkpoints'
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class AugmentationConfig:
    """Warp-affine + photometric augmentation bounds."""
    square_length: int = 512
    flip_prob: float = 0.5
    max_rotate: float = 45.0
    min_scale: float = 0.5
    max_scale: float = 2.0
    min_stretch: float = 0.95
    max_stretch: float = 1.05
    max_translate: int = 150
    gray_prob: float = 0.02
    color_tint_prob: float = 0.2
    annotation_jitter_prob: float = 0.2


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
