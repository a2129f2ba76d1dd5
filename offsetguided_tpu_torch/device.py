"""Device resolution and the numeric policy for parity runs."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the card. A caller that wants the CPU says so; there is
    no silent fallback when no card is present."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('a CUDA device was requested but none is '
                           'available; pass device="cpu" to run on the CPU')
    return dev


def disable_tf32() -> None:
    """Full fp32 convolutions and matmuls (cuDNN defaults to TF32 for
    convolutions), as parity runs against the fp32 reference need."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
