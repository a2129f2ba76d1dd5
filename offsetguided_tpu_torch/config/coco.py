"""COCO-2017 keypoint taxonomy, skeleton variants, OKS sigmas and flip tables.

Pure data + index computation, no JAX. Capability parity with the reference
config layer (reference: config/coco_data.py:12-178). The skeleton/sigma values
are the public COCO keypoint-challenge constants.
"""
from __future__ import annotations

import numpy as np

# ImageNet normalization used by the pretrained backbones
# (reference: config/coco_data.py:9-10).
DATA_MEAN = (0.485, 0.456, 0.406)
DATA_STD = (0.229, 0.224, 0.225)

# COCO dataset channel statistics (reference: config/coco_data.py:6-7).
COCO_MEAN = (0.40789654, 0.44719302, 0.47026115)
COCO_STD = (0.28863828, 0.27408164, 0.27809835)

COCO_KEYPOINTS = (
    'nose',            # 0
    'left_eye',        # 1
    'right_eye',       # 2
    'left_ear',        # 3
    'right_ear',       # 4
    'left_shoulder',   # 5
    'right_shoulder',  # 6
    'left_elbow',      # 7
    'right_elbow',     # 8
    'left_wrist',      # 9
    'right_wrist',     # 10
    'left_hip',        # 11
    'right_hip',       # 12
    'left_knee',       # 13
    'right_knee',      # 14
    'left_ankle',      # 15
    'right_ankle',     # 16
)

LEFT_INDEX = tuple(i for i, n in enumerate(COCO_KEYPOINTS) if n.startswith('left'))
RIGHT_INDEX = tuple(i for i, n in enumerate(COCO_KEYPOINTS) if n.startswith('right'))

# Per-keypoint OKS falloff constants from the COCO keypoint evaluation protocol
# (reference: config/coco_data.py:79-97).
COCO_PERSON_SIGMAS = (
    0.026,                  # nose
    0.025, 0.025,           # eyes
    0.035, 0.035,           # ears
    0.079, 0.079,           # shoulders
    0.072, 0.072,           # elbows
    0.062, 0.062,           # wrists
    0.107, 0.107,           # hips
    0.087, 0.087,           # knees
    0.089, 0.089,           # ankles
)

# 19-limb default guiding-offset skeleton (reference: config/coco_data.py:12-15).
COCO_PERSON_SKELETON = (
    (0, 1), (0, 2), (1, 2), (1, 3), (2, 4), (5, 6), (4, 6), (3, 5),
    (5, 7), (7, 9), (6, 8), (8, 10), (5, 11), (6, 12), (11, 12), (11, 13),
    (13, 15), (12, 14), (14, 16),
)

# 31-limb redundant variant (reference: config/coco_data.py:22-28).
COCO_PERSON_WITH_REDUNDANT_SKELETON = COCO_PERSON_SKELETON + (
    (1, 5), (2, 6), (5, 12), (6, 11), (11, 14), (12, 13),
    (5, 9), (6, 10), (11, 15), (12, 16),
    (5, 0), (6, 0),
)

# 44-limb dense variant (reference: config/coco_data.py:30-36).
DENSER_COCO_PERSON_SKELETON = (
    (0, 1), (0, 2), (1, 2), (0, 3), (0, 4), (3, 4), (0, 5), (0, 6), (1, 5),
    (2, 6), (1, 3), (2, 4), (3, 5), (4, 6), (5, 6), (5, 11), (6, 12), (5, 12),
    (6, 11), (11, 12), (5, 7), (6, 8), (7, 9), (8, 10), (5, 9), (6, 10), (7, 8),
    (9, 10), (9, 11), (10, 12), (9, 13), (10, 14), (13, 11), (14, 12),
    (11, 14), (12, 13), (11, 15), (12, 16), (15, 13), (16, 14),
    (13, 16), (14, 15), (13, 14), (15, 16),
)

# Dense limbs that are not in the default skeleton (reference:
# config/coco_data.py:38-42); 29 connections, though the reference names
# their head 'omp25'.
REDUNDANT_CONNECTIONS = tuple(
    c for c in DENSER_COCO_PERSON_SKELETON if c not in COCO_PERSON_SKELETON
)

# 16-limb kinematic tree (reference: config/coco_data.py:44-53).
KINEMATIC_TREE_SKELETON = (
    (0, 1), (1, 3),
    (0, 2), (2, 4),
    (0, 5),
    (5, 7), (7, 9),
    (0, 6),
    (6, 8), (8, 10),
    (5, 11), (11, 13), (13, 15),
    (6, 12), (12, 14), (14, 16),
)

# limb count -> skeleton (the reference's omp/omp16/omp25/omp31/omp44 heads)
SKELETONS_BY_SIZE = {
    19: COCO_PERSON_SKELETON,
    16: KINEMATIC_TREE_SKELETON,
    25: REDUNDANT_CONNECTIONS,
    31: COCO_PERSON_WITH_REDUNDANT_SKELETON,
    44: DENSER_COCO_PERSON_SKELETON,
}

HFLIP = {
    name: name.replace('left', 'right') if name.startswith('left')
    else name.replace('right', 'left')
    for name in COCO_KEYPOINTS if name.startswith(('left', 'right'))
}


def heatmap_hflip(keypoints=COCO_KEYPOINTS, hflip=None) -> np.ndarray:
    """Channel permutation that maps a horizontally flipped heatmap stack back to
    the original keypoint ordering (reference: config/coco_data.py:119-127).

    Returns an int array `perm` such that `flipped_hmp[perm]` aligns with the
    un-flipped prediction.
    """
    hflip = HFLIP if hflip is None else hflip
    return np.asarray(
        [keypoints.index(hflip.get(name, name)) for name in keypoints],
        dtype=np.int32)


def offset_hflip(keypoints=COCO_KEYPOINTS, skeleton=COCO_PERSON_SKELETON,
                 hflip=None) -> tuple[np.ndarray, np.ndarray]:
    """Limb-channel flip permutation for guiding-offset maps.

    Returns `(flip_indices, reserve_indices)`:
    - `flip_indices[i]` is the limb channel in the flipped prediction that
      corresponds to limb `i` of the original prediction.
    - `reserve_indices` lists limbs whose mirrored counterpart runs in the
      *reversed* direction (from<->to swapped); for those the flipped offsets
      point backwards and must not be vector-averaged with the originals
      (reference: config/coco_data.py:130-153, used at decoder/factory.py:129-139).
    """
    hflip = HFLIP if hflip is None else hflip
    names = [(keypoints[a], keypoints[b]) for a, b in skeleton]
    flipped = [(hflip.get(a, a), hflip.get(b, b)) for a, b in names]

    flip_indices = list(range(len(skeleton)))
    reserve_indices = []
    for i, (a, b) in enumerate(names):
        if (a, b) in flipped:
            flip_indices[i] = flipped.index((a, b))
        if (b, a) in flipped:
            flip_indices[i] = flipped.index((b, a))
            reserve_indices.append(i)
    return (np.asarray(flip_indices, dtype=np.int32),
            np.asarray(reserve_indices, dtype=np.int32))

