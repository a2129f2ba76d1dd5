"""The 4-stage hourglass backbone (IMHN / SimplePose style), NCHW.

Same structure as the JAX package's `models/hourglass4stage.py`:
- `DilatedStem`: a 7x7 stride-2 conv (64, LeakyReLU 0.01), a bottleneck to
  128, a 2x2 max pool, a second bottleneck, then six dilated 3x3 convs
  (dilations 3, 3, 4, 4, 5, 5; 128 channels, LeakyReLU 0.01) whose output
  is concatenated with their input: 256 channels at stride 4;
- `n_stacks` fourth-order `HourglassBlock`s whose width grows by 128 a
  scale (256 -> 384 -> 512 -> 640 -> 768);
- per stack two 3x3 feature ConvBNs (256, LeakyReLU 0.01) and
  squeeze-and-excitation: the stack's stride-4 output of `feat_dim` = 256
  channels, whatever `cnv_dim` says;
- between stacks the feedback `x + ConvBN1x1(feat)` (no activation).

In a serving or evaluation loop's sampled batches the device time of the
stem's dilated convs and concat (`net.dilated`) and of each stack's
squeeze-and-excitation (`net.se`) is recorded
(`utils/profiling.py::Recorder.device_stage`).

`ModelConfig`'s hourglass104 widths (`dims`, `modules`, `hg_order`,
`cnv_dim`) do not apply, as in the JAX package; `n_stacks` and `remat` do.
The reference declares this network without weights, so its module names
are the port's own (`stem`, `hgs.{s}` with `up1`/`low1`/`low2`/`low3`,
`features.{s}`, `feedback.{s}`); `models/checkpoint.py` maps them to the
JAX package's flax paths.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from ..config.defaults import ModelConfig
from ..utils.profiling import RECORDER
from .layers import (BottleneckResidual, ConvBN, SELayer, max_pool2x,
                     remat_call, upsample_nearest2x)

DILATIONS = (3, 3, 4, 4, 5, 5)


class DilatedStem(nn.Module):
    """Stride-4 stem with stacked dilated convs; 256 output channels."""

    def __init__(self):
        super().__init__()
        self.conv = ConvBN(7, 3, 64, stride=2, leaky=0.01)
        self.res1 = BottleneckResidual(64, 128)
        self.res2 = BottleneckResidual(128, 128)
        self.dilated = nn.Sequential(*[
            ConvBN(3, 128, 128, leaky=0.01, dilation=d) for d in DILATIONS])

    def forward(self, x):
        x = self.res2(max_pool2x(self.res1(self.conv(x))))
        with RECORDER.device_stage('net.dilated', x):
            return torch.cat([x, self.dilated(x)], dim=1)


class HourglassBlock(nn.Module):
    """Hourglass of order `depth` with `increase` more channels a scale."""

    def __init__(self, depth: int, feat: int, increase: int):
        super().__init__()
        nxt = feat + increase
        self.up1 = BottleneckResidual(feat, feat)
        self.low1 = BottleneckResidual(feat, nxt)
        self.low2 = (HourglassBlock(depth - 1, nxt, increase) if depth > 1
                     else BottleneckResidual(nxt, nxt))
        self.low3 = BottleneckResidual(nxt, feat)

    def forward(self, x):
        low = self.low3(self.low2(self.low1(max_pool2x(x))))
        return self.up1(x) + upsample_nearest2x(low)


class Hourglass4Stage(nn.Module):
    """Stacked 4-stage hourglass; returns a list of per-stack
    (N, feat_dim, H/4, W/4) features."""

    increase = 128
    feat_dim = 256

    def __init__(self, cfg: ModelConfig = ModelConfig(
            basenet='hourglass4stage')):
        super().__init__()
        n, f = cfg.n_stacks, self.feat_dim
        self.stem = DilatedStem()
        self.hgs = nn.ModuleList([HourglassBlock(4, f, self.increase)
                                  for _ in range(n)])
        self.features = nn.ModuleList([nn.Sequential(
            ConvBN(3, f, f, leaky=0.01), ConvBN(3, f, f, leaky=0.01),
            SELayer(f)) for _ in range(n)])
        self.feedback = nn.ModuleList([ConvBN(1, f, f, relu=False)
                                       for _ in range(n - 1)])
        self.remat = cfg.remat

    def forward(self, x) -> List[torch.Tensor]:
        x = self.stem(x)
        outs = []
        for s, (hg, feat) in enumerate(zip(self.hgs, self.features)):
            y = feat(remat_call(hg, x, self.remat))
            outs.append(y)
            if s < len(self.hgs) - 1:
                x = x + self.feedback[s](y)
        return outs
