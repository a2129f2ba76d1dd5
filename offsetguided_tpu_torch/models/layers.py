"""Building blocks of the hourglass backbone, NCHW `nn.Module`s.

Attribute names follow the reference module tree (`conv`/`bn`,
`conv1`/`bn1`/`conv2`/`bn2`/`skip`), so a reference state dict loads with
`strict=True`; the 4-stage backbone's blocks (`BottleneckResidual`,
`SELayer`) have no reference names and take the same scheme
(`conv3`/`bn3`, `fc1`/`fc2`). Convolutions use torch padding
`dilation*(k-1)//2`.

`BatchNorm2d` trains with the JAX package's BatchNorm semantics (fp32
statistics, fast variance, biased running variance); in eval mode it is the
stock layer. For inference, `fold_batchnorm` folds each eval-mode BatchNorm
into the convolution before it (w' = w * gamma/sqrt(var+eps), b' = beta -
mean * that, computed in fp32), as the JAX eval path does; the model can
then run in bf16 with the BN affine riding each convolution's accumulator.
`sync_batchnorm` makes the train-mode statistics those of a data-parallel
group's global batch.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..utils.profiling import RECORDER


class _TrainNorm(torch.autograd.Function):
    """Train-mode BatchNorm over (N, H, W) in fp32 (or wider). Saves only
    its input (the convolution's output, bf16 under autocast) and the
    per-channel statistics; the backward recomputes the normalized input.
    The gradient of the fast variance E[x^2] - E[x]^2 is that of the
    two-pass variance, so the backward is the standard one.

    With a process `group` the statistics are those of the global batch,
    as under the JAX trainer's jit over a batch sharded on `data`: the
    forward all-reduces the stacked [sum x, sum x^2, n] once, the backward
    [sum g, sum g * xhat] once, both in the statistics' dtype. `dx` is then
    the global batch's, and `dw` / `db` are this rank's shares (the
    gradient reduction sums them)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group=None):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if group is None:
            mean = xf.mean(dim=(0, 2, 3))
            var = (xf * xf).mean(dim=(0, 2, 3)) - mean * mean
            n = x.numel() // x.shape[1]
        else:
            n_local = xf.numel() // xf.shape[1]
            stats = torch.stack([xf.sum(dim=(0, 2, 3)),
                                 (xf * xf).sum(dim=(0, 2, 3)),
                                 xf.new_full((xf.shape[1],), n_local)])
            dist.all_reduce(stats, group=group)
            n = stats[2]
            mean = stats[0] / n
            var = stats[1] / n - mean * mean
        rstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.n, ctx.group = n, group
        y = (xf - mean[:, None, None]) * rstd[:, None, None]
        y = y * weight[:, None, None] + bias[:, None, None]
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, rstd = ctx.saved_tensors
        g = dy.to(mean.dtype)
        xhat = (x.to(mean.dtype) - mean[:, None, None]) * rstd[:, None, None]
        n = ctx.n
        db = g.sum(dim=(0, 2, 3))
        dw = (g * xhat).sum(dim=(0, 2, 3))
        sdb, sdw = db, dw
        if ctx.group is not None:
            sums = torch.stack([db, dw])
            dist.all_reduce(sums, group=ctx.group)
            sdb, sdw = sums[0], sums[1]
        dx = (g - (sdb / n)[:, None, None] - xhat * (sdw / n)[:, None, None])
        dx = dx * (weight * rstd)[:, None, None]
        return dx.to(x.dtype), dw, db, None, None


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
    is the stock layer, in fp32 for a lower-precision input.

    `sync_group` (set by `sync_batchnorm`) takes the train-mode statistics
    over the process group's global batch (`_TrainNorm`); the running
    statistics then move equally on every rank. None (the default) is the
    one-process layer."""

    update_statistics = True
    sync_group = None

    def forward(self, x):
        if not self.training:
            return super().forward(x.float() if x.dtype != self.weight.dtype
                                   else x)
        y, mean, var = _TrainNorm.apply(x, self.weight, self.bias, self.eps,
                                        self.sync_group)
        if not self.update_statistics:
            return y
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            f = (1.0 / float(self.num_batches_tracked)
                 if self.momentum is None else self.momentum)
            self.running_mean.mul_(1.0 - f).add_(mean, alpha=f)
            self.running_var.mul_(1.0 - f).add_(var, alpha=f)
        return y


def sync_batchnorm(module: nn.Module, group) -> nn.Module:
    """Every `BatchNorm2d` of `module` takes its train-mode statistics over
    `group` (None: back to the one-process layer). Returns `module`."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.sync_group = group
    return module


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


def activate(x: torch.Tensor, leaky: float) -> torch.Tensor:
    """ReLU, or LeakyReLU of slope `leaky` where it is nonzero."""
    return F.leaky_relu(x, leaky) if leaky else torch.relu(x)


def remat_call(module: nn.Module, x, remat: bool):
    """`module(x)`; with `remat` in training, its activations are
    recomputed in the backward instead of stored (the recompute leaves the
    BatchNorm running statistics alone)."""
    if not (remat and module.training and torch.is_grad_enabled()):
        return module(x)
    return checkpoint(module, x, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          frozen_statistics(module)))


class ConvBN(nn.Module):
    """k x k conv + BN + optional ReLU (LeakyReLU of slope `leaky` where it
    is nonzero). Padding is `dilation * (k - 1) // 2` a side, the JAX
    package's 'TORCH' padding."""

    def __init__(self, k: int, in_ch: int, out_ch: int, stride: int = 1,
                 relu: bool = True, leaky: float = 0.0, dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, k, stride=stride,
                              padding=dilation * (k - 1) // 2,
                              dilation=dilation, bias=False)
        self.bn = BatchNorm2d(out_ch)
        self.relu = relu
        self.leaky = leaky

    def forward(self, x):
        y = self.bn(self.conv(x))
        return activate(y, self.leaky) if self.relu else y


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


class BottleneckResidual(nn.Module):
    """1x1 conv to half the width, 3x3 at half, 1x1 to full, each with BN;
    LeakyReLU 0.01 after the first two and after the add; the skip is a
    projected 1x1 conv + BN (`skip.0` / `skip.1`) when the width changes.
    Used by the 4-stage backbone."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        half = out_ch // 2
        self.conv1 = nn.Conv2d(in_ch, half, 1, bias=False)
        self.bn1 = BatchNorm2d(half)
        self.conv2 = nn.Conv2d(half, half, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(half)
        self.conv3 = nn.Conv2d(half, out_ch, 1, bias=False)
        self.bn3 = BatchNorm2d(out_ch)
        self.skip = (conv_bn_seq(in_ch, out_ch) if in_ch != out_ch
                     else nn.Sequential())

    def forward(self, x):
        y = F.leaky_relu(self.bn1(self.conv1(x)), 0.01)
        y = F.leaky_relu(self.bn2(self.conv2(y)), 0.01)
        y = self.bn3(self.conv3(y))
        return F.leaky_relu(y + self.skip(x), 0.01)


class SELayer(nn.Module):
    """Squeeze-and-excitation: the spatial mean in fp32 or wider whatever
    the input's type (the JAX package takes it in fp32), Linear c -> c/16,
    ReLU, Linear c/16 -> c, sigmoid, channel scale. The Linear layers run
    in the type of their weights (bf16 in the eval-mode backbone, as the
    JAX package's Dense layers run in the compute type; under autocast in
    training). In a serving or evaluation loop's sampled batches its
    device time is recorded as the stage `net.se`
    (`utils/profiling.py::Recorder.device_stage`)."""

    def __init__(self, ch: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(ch, ch // reduction)
        self.fc2 = nn.Linear(ch // reduction, ch)

    def forward(self, x):
        with RECORDER.device_stage('net.se', x):
            s = x.to(torch.promote_types(x.dtype, torch.float32)).mean(
                dim=(2, 3)).to(self.fc1.weight.dtype)
            s = torch.sigmoid(self.fc2(torch.relu(self.fc1(s))))
            return x * s[:, :, None, None].to(x.dtype)


def max_pool2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pooling, stride 2, VALID."""
    return F.max_pool2d(x, 2, 2)


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


_PAIRS = (('conv', 'bn'), ('conv1', 'bn1'), ('conv2', 'bn2'),
          ('conv3', 'bn3'), ('0', '1'))


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
