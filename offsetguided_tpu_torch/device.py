"""Device resolution and the numeric policy for parity runs."""
from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def exact_fp32():
    """For the block: full fp32 convolutions and matmuls, and cuDNN's
    deterministic algorithms, so that a seeded run repeats on one card and
    software stack; the previous settings come back after it."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
             cudnn.benchmark)
    disable_tf32()
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
         cudnn.benchmark) = saved
