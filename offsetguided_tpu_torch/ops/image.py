"""On-device image normalization (uint8 travels to the card, 4x fewer bytes
than float32; the ImageNet normalization runs there, with the mean and std
copied to the device once)."""
from __future__ import annotations

import torch

from ..config import DATA_MEAN, DATA_STD
from .constants import on_device


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 RGB -> ImageNet-normalized float32. Float input
    is taken as already normalized and passed through unchanged."""
    if images.dtype != torch.uint8:
        return images
    mean = on_device(DATA_MEAN, images.device, torch.float32)
    std = on_device(DATA_STD, images.device, torch.float32)
    return (images.float() / 255.0 - mean) / std
