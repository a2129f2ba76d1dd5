"""Hourglass-104 backbone (CornerNet/CenterNet exkp), NCHW.

Same structure as the JAX package's `models/hourglass104.py`:
- stem: 7x7 s2 conv-BN-ReLU (128) + stride-2 residual (256) -> stride 4,
- `n_stacks` recursive hourglass modules over `dims`/`modules`,
- downsampling by the first stride-2 residual of each `low1` branch,
  upsampling by nearest 2x,
- inter-stack fusion inter = relu(1x1BN(inter) + 1x1BN(cnv)) -> residual.

Submodules carry the reference names (`pre.0`, `kps.{s}.up1/low1/low2/low3`,
`cnvs`, `inters_`, `cnvs_`, `inters`), so a reference state dict loads with
`strict=True`. Returns the per-stack `cnv_dim`-channel stride-4 features.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from ..config.defaults import ModelConfig
from .layers import (BasicResidual, ConvBN, conv_bn_seq, remat_call,
                     upsample_nearest2x)


class KPModule(nn.Module):
    """Recursive hourglass block. `in_dim` differs from `dims[0]` only in
    narrow test configs (the stem always gives 256 channels)."""

    def __init__(self, n: int, dims: Sequence[int], modules: Sequence[int],
                 in_dim: int):
        super().__init__()
        curr_dim, next_dim = dims[0], dims[1]
        curr_mod, next_mod = modules[0], modules[1]
        self.up1 = nn.Sequential(*[
            BasicResidual(in_dim if m == 0 else curr_dim, curr_dim)
            for m in range(curr_mod)])
        self.low1 = nn.Sequential(
            BasicResidual(in_dim, next_dim, stride=2),
            *[BasicResidual(next_dim, next_dim) for _ in range(curr_mod - 1)])
        if n > 1:
            self.low2 = KPModule(n - 1, dims[1:], modules[1:], next_dim)
        else:
            self.low2 = nn.Sequential(*[
                BasicResidual(next_dim, next_dim) for _ in range(next_mod)])
        self.low3 = nn.Sequential(
            *[BasicResidual(next_dim, next_dim) for _ in range(curr_mod - 1)],
            BasicResidual(next_dim, curr_dim))

    def forward(self, x):
        low = self.low3(self.low2(self.low1(x)))
        return self.up1(x) + upsample_nearest2x(low)


class Hourglass104(nn.Module):
    """Stacked hourglass; returns a list of per-stack (N, C, H/4, W/4)."""

    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        dims, modules = tuple(cfg.dims), tuple(cfg.modules)
        n = cfg.n_stacks
        self.pre = nn.Sequential(ConvBN(7, 3, 128, stride=2),
                                 BasicResidual(128, 256, stride=2))
        self.kps = nn.ModuleList([KPModule(cfg.hg_order, dims, modules, 256)
                                  for _ in range(n)])
        self.cnvs = nn.ModuleList([ConvBN(3, dims[0], cfg.cnv_dim)
                                   for _ in range(n)])
        self.inters_ = nn.ModuleList([conv_bn_seq(256, 256)
                                      for _ in range(n - 1)])
        self.cnvs_ = nn.ModuleList([conv_bn_seq(cfg.cnv_dim, 256)
                                    for _ in range(n - 1)])
        self.inters = nn.ModuleList([BasicResidual(256, 256)
                                     for _ in range(n - 1)])
        self.remat = cfg.remat
        self.feat_dim = cfg.cnv_dim

    def forward(self, x) -> List[torch.Tensor]:
        inter = self.pre(x)
        outs = []
        for s, (kp, cnv) in enumerate(zip(self.kps, self.cnvs)):
            y = cnv(remat_call(kp, inter, self.remat))
            outs.append(y)
            if s < len(self.kps) - 1:
                inter = torch.relu(self.inters_[s](inter) + self.cnvs_[s](y))
                inter = self.inters[s](inter)
        return outs
