"""On-device image normalization (uint8 travels to the card, 4x fewer bytes
than float32; the ImageNet normalization runs there)."""
from __future__ import annotations

import torch

from ..config import DATA_MEAN, DATA_STD


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 RGB -> ImageNet-normalized float32. Float input
    is taken as already normalized and passed through unchanged."""
    if images.dtype != torch.uint8:
        return images
    mean = torch.tensor(DATA_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(DATA_STD, dtype=torch.float32, device=images.device)
    return (images.float() / 255.0 - mean) / std
