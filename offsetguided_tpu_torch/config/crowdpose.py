"""CrowdPose 14-keypoint taxonomy, skeleton, OKS sigmas and flip tables.

The port's own copy of the JAX package's `config/crowdpose.py`: the sigmas
are the public crowdpose-api values; the guiding-offset skeleton (17 limbs
over the 14 joints) follows the COCO one's design rules (short limbs
between adjacent joints, head and torso first). Pure data and index
computation.
"""
from __future__ import annotations

import numpy as np

from .coco import heatmap_hflip, offset_hflip

CROWDPOSE_KEYPOINTS = (
    'left_shoulder',   # 0
    'right_shoulder',  # 1
    'left_elbow',      # 2
    'right_elbow',     # 3
    'left_wrist',      # 4
    'right_wrist',     # 5
    'left_hip',        # 6
    'right_hip',       # 7
    'left_knee',       # 8
    'right_knee',      # 9
    'left_ankle',      # 10
    'right_ankle',     # 11
    'head_top',        # 12
    'neck',            # 13
)

CROWDPOSE_SIGMAS = (
    0.079, 0.079,  # shoulders
    0.072, 0.072,  # elbows
    0.062, 0.062,  # wrists
    0.107, 0.107,  # hips
    0.087, 0.087,  # knees
    0.089, 0.089,  # ankles
    0.079,         # head_top
    0.079,         # neck
)

# 17 guiding-offset limbs over the 14 joints
CROWDPOSE_PERSON_SKELETON = (
    (12, 13),            # head_top -> neck
    (13, 0), (13, 1),    # neck -> shoulders
    (0, 1),              # shoulder bridge
    (0, 2), (2, 4),      # left arm
    (1, 3), (3, 5),      # right arm
    (13, 6), (13, 7),    # neck -> hips
    (0, 6), (1, 7),      # shoulders -> hips
    (6, 7),              # hip bridge
    (6, 8), (8, 10),     # left leg
    (7, 9), (9, 11),     # right leg
)

CROWDPOSE_HFLIP = {
    name: name.replace('left', 'right') if name.startswith('left')
    else name.replace('right', 'left')
    for name in CROWDPOSE_KEYPOINTS if name.startswith(('left', 'right'))
}

LEFT_INDEX = tuple(i for i, n in enumerate(CROWDPOSE_KEYPOINTS)
                   if n.startswith('left'))
RIGHT_INDEX = tuple(i for i, n in enumerate(CROWDPOSE_KEYPOINTS)
                    if n.startswith('right'))


def crowdpose_hflip_indices() -> np.ndarray:
    return heatmap_hflip(CROWDPOSE_KEYPOINTS, CROWDPOSE_HFLIP)


def crowdpose_offset_hflip() -> tuple[np.ndarray, np.ndarray]:
    return offset_hflip(CROWDPOSE_KEYPOINTS, CROWDPOSE_PERSON_SKELETON,
                        CROWDPOSE_HFLIP)
