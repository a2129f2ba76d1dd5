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
from .defaults import (
    DecoderConfig,
    EncoderConfig,
    EvalConfig,
    HeadsConfig,
    ModelConfig,
    SkeletonConfig,
)

__all__ = [
    'COCO_KEYPOINTS', 'COCO_PERSON_SIGMAS', 'COCO_PERSON_SKELETON',
    'DATA_MEAN', 'DATA_STD', 'HFLIP',
    'heatmap_hflip', 'offset_hflip',
    'DecoderConfig', 'EncoderConfig', 'EvalConfig', 'HeadsConfig', 'ModelConfig',
    'SkeletonConfig',
]
