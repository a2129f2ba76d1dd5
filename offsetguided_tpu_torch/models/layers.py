"""Building blocks of the hourglass backbone, NCHW `nn.Module`s.

Attribute names follow the reference module tree (`conv`/`bn`,
`conv1`/`bn1`/`conv2`/`bn2`/`skip`), so a reference state dict loads with
`strict=True`. Convolutions use torch padding `(k-1)//2`.

`BatchNorm2d` trains with the JAX package's BatchNorm semantics (fp32
statistics, fast variance, biased running variance); in eval mode it is the
stock layer. For inference, `fold_batchnorm` folds each eval-mode BatchNorm
into the convolution before it (w' = w * gamma/sqrt(var+eps), b' = beta -
mean * that, computed in fp32), as the JAX eval path does; the model can
then run in bf16 with the BN affine riding each convolution's accumulator.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn


class _TrainNorm(torch.autograd.Function):
    """Train-mode BatchNorm over (N, H, W) in fp32 (or wider). Saves only
    its input (the convolution's output, bf16 under autocast) and the
    per-channel statistics; the backward recomputes the normalized input.
    The gradient of the fast variance E[x^2] - E[x]^2 is that of the
    two-pass variance, so the backward is the standard one."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=(0, 2, 3))
        var = (xf * xf).mean(dim=(0, 2, 3)) - mean * mean
        rstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, rstd)
        y = (xf - mean[:, None, None]) * rstd[:, None, None]
        y = y * weight[:, None, None] + bias[:, None, None]
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, rstd = ctx.saved_tensors
        g = dy.to(mean.dtype)
        xhat = (x.to(mean.dtype) - mean[:, None, None]) * rstd[:, None, None]
        n = x.numel() // x.shape[1]
        db = g.sum(dim=(0, 2, 3))
        dw = (g * xhat).sum(dim=(0, 2, 3))
        dx = (g - (db / n)[:, None, None] - xhat * (dw / n)[:, None, None])
        dx = dx * (weight * rstd)[:, None, None]
        return dx.to(x.dtype), dw, db, None


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with the JAX package's training semantics, on the stock
    layer's parameters and buffers (`weight`, `bias`, `running_mean`,
    `running_var`), so state dicts keep the reference layout.

    Train mode: mean = E[x] and var = E[x^2] - E[x]^2 (flax's fast
    variance) in fp32 over (N, H, W); the output is normalized by that
    biased var and is fp32; the running statistics move by
    `running = (1 - momentum) * running + momentum * batch` with the BIASED
    var (the stock layer stores the unbiased one). `momentum` keeps torch's
    convention: the JAX momentum 0.9 is 0.1 here (`PoseNet` sets it from
    `ModelConfig.bn_momentum`); None is the cumulative average. Eval mode
    is the stock layer, in fp32 for a lower-precision input."""

    update_statistics = True

    def forward(self, x):
        if not self.training:
            return super().forward(x.float() if x.dtype != self.weight.dtype
                                   else x)
        y, mean, var = _TrainNorm.apply(x, self.weight, self.bias, self.eps)
        if not self.update_statistics:
            return y
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            f = (1.0 / float(self.num_batches_tracked)
                 if self.momentum is None else self.momentum)
            self.running_mean.mul_(1.0 - f).add_(mean, alpha=f)
            self.running_var.mul_(1.0 - f).add_(var, alpha=f)
        return y


@contextlib.contextmanager
def frozen_statistics(module: nn.Module):
    """Within the context, the `BatchNorm2d`s of `module` normalize as
    usual but leave their running statistics alone (a recompute of
    activations for the backward must not count a batch twice)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.update_statistics = False
    try:
        yield
    finally:
        for m in bns:
            del m.update_statistics


class ConvBN(nn.Module):
    """k x k conv + BN + optional ReLU."""

    def __init__(self, k: int, in_ch: int, out_ch: int, stride: int = 1,
                 relu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, k, stride=stride,
                              padding=(k - 1) // 2, bias=False)
        self.bn = BatchNorm2d(out_ch)
        self.relu = relu

    def forward(self, x):
        y = self.bn(self.conv(x))
        return torch.relu(y) if self.relu else y


def conv_bn_seq(in_ch: int, out_ch: int) -> nn.Sequential:
    """1x1 conv + BN as a `Sequential` (reference keys `.0`/`.1`)."""
    return nn.Sequential(nn.Conv2d(in_ch, out_ch, 1, bias=False),
                         BatchNorm2d(out_ch))


class BasicResidual(nn.Module):
    """Two 3x3 convs + projection skip when the shape changes."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = BatchNorm2d(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(out_ch)
        if stride != 1 or in_ch != out_ch:
            self.skip = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
                BatchNorm2d(out_ch))
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
