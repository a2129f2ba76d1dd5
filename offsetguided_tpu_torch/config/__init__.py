from .coco import (
    COCO_KEYPOINTS,
    COCO_PERSON_SIGMAS,
    COCO_PERSON_SKELETON,
    DATA_MEAN,
    DATA_STD,
    HFLIP,
    heatmap_hflip,
    offset_hflip,
)
from .crowdpose import (
    CROWDPOSE_HFLIP,
    CROWDPOSE_KEYPOINTS,
    CROWDPOSE_PERSON_SKELETON,
    CROWDPOSE_SIGMAS,
    crowdpose_hflip_indices,
    crowdpose_offset_hflip,
)
from .defaults import (
    AugmentationConfig,
    DecoderConfig,
    EncoderConfig,
    EvalConfig,
    HeadsConfig,
    LossConfig,
    ModelConfig,
    SkeletonConfig,
    TrainConfig,
)

__all__ = [
    'COCO_KEYPOINTS', 'COCO_PERSON_SIGMAS', 'COCO_PERSON_SKELETON',
    'DATA_MEAN', 'DATA_STD', 'HFLIP',
    'heatmap_hflip', 'offset_hflip',
    'CROWDPOSE_HFLIP', 'CROWDPOSE_KEYPOINTS', 'CROWDPOSE_PERSON_SKELETON',
    'CROWDPOSE_SIGMAS', 'crowdpose_hflip_indices', 'crowdpose_offset_hflip',
    'AugmentationConfig', 'DecoderConfig', 'EncoderConfig', 'EvalConfig',
    'HeadsConfig', 'LossConfig', 'ModelConfig', 'SkeletonConfig',
    'TrainConfig',
]
