"""Building blocks of the hourglass backbone, NCHW `nn.Module`s.

Attribute names follow the reference module tree (`conv`/`bn`,
`conv1`/`bn1`/`conv2`/`bn2`/`skip`), so a reference state dict loads with
`strict=True`. Convolutions use torch padding `(k-1)//2`.

For inference, `fold_batchnorm` folds each eval-mode BatchNorm into the
convolution before it (w' = w * gamma/sqrt(var+eps), b' = beta - mean * that,
computed in fp32), as the JAX eval path does; the model can then run in bf16
with the BN affine riding each convolution's accumulator.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class ConvBN(nn.Module):
    """k x k conv + BN + optional ReLU."""

    def __init__(self, k: int, in_ch: int, out_ch: int, stride: int = 1,
                 relu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, k, stride=stride,
                              padding=(k - 1) // 2, bias=False)
        self.bn = nn.BatchNorm2d(out_ch)
        self.relu = relu

    def forward(self, x):
        y = self.bn(self.conv(x))
        return torch.relu(y) if self.relu else y


def conv_bn_seq(in_ch: int, out_ch: int) -> nn.Sequential:
    """1x1 conv + BN as a `Sequential` (reference keys `.0`/`.1`)."""
    return nn.Sequential(nn.Conv2d(in_ch, out_ch, 1, bias=False),
                         nn.BatchNorm2d(out_ch))


class BasicResidual(nn.Module):
    """Two 3x3 convs + projection skip when the shape changes."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(out_ch)
        if stride != 1 or in_ch != out_ch:
            self.skip = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
                nn.BatchNorm2d(out_ch))
        else:
            self.skip = nn.Sequential()

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + self.skip(x))


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """Repeat each pixel 2x2 (`nn.Upsample(scale_factor=2)`)."""
    return F.interpolate(x, scale_factor=2, mode='nearest')


def _folded(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> nn.Conv2d:
    w = conv.weight.detach().float()
    s = bn.weight.detach().float() * torch.rsqrt(
        bn.running_var.detach().float() + bn.eps)
    b = bn.bias.detach().float() - bn.running_mean.detach().float() * s
    if conv.bias is not None:
        b = b + conv.bias.detach().float() * s
    out = nn.Conv2d(conv.in_channels, conv.out_channels, conv.kernel_size,
                    stride=conv.stride, padding=conv.padding,
                    dilation=conv.dilation, bias=True,
                    device=conv.weight.device)
    with torch.no_grad():
        out.weight.copy_(w * s[:, None, None, None])
        out.bias.copy_(b)
    return out


_PAIRS = (('conv', 'bn'), ('conv1', 'bn1'), ('conv2', 'bn2'), ('0', '1'))


def fold_batchnorm(module: nn.Module) -> nn.Module:
    """Fold every (conv, BatchNorm) pair of `module` in place (eval only):
    the conv gains the BN affine as weight scale and bias, the BN becomes
    an `Identity`. Returns `module`."""
    for m in list(module.modules()):
        for c_name, b_name in _PAIRS:
            conv, bn = m._modules.get(c_name), m._modules.get(b_name)
            if isinstance(conv, nn.Conv2d) and isinstance(bn, nn.BatchNorm2d):
                setattr(m, c_name, _folded(conv, bn))
                setattr(m, b_name, nn.Identity())
    return module
