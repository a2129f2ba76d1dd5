"""Prediction heads: per-stack convs over the backbone features.

The parameters sit in the reference layout (`headnets.0.hp_convs/bghp_convs/
jitter_convs`, `headnets.1.reg_convs/spread_convs/scale_convs`). The default
heads are 1x1 convs, and the forward pass runs every head of a stack as ONE
fp32 matmul over the NHWC features with the head kernels concatenated on the
output axis, as the JAX package's fused head pass does. With
`HeadsConfig(tower=True)` each head is a tower instead: a 3x3 conv (torch
padding 1, the JAX package's SAME at stride 1, with bias) to `tower_dim`
channels, ReLU, and a 1x1 conv (with bias), held as a `Sequential` (keys
`.0` and `.2`); the towers run unfused, one head after another, as in the
JAX package. Both kinds keep the port's head precision policy: fp32
parameters and fp32 compute over the features (the JAX package computes
its heads in the compute type and casts their outputs to fp32). Outputs
are fp32 NHWC lists per stack, `None` for absent heads.
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from ..config.defaults import HeadsConfig

HEAD_KEYS = ('hmp', 'bg', 'jomp', 'omp', 'spread', 'scmp')


def _convs(cfg: HeadsConfig, in_ch: int, out_ch: int,
           n_stacks: int) -> nn.ModuleList:
    if cfg.tower:
        return nn.ModuleList([nn.Sequential(
            nn.Conv2d(in_ch, cfg.tower_dim, 3, padding=1), nn.ReLU(),
            nn.Conv2d(cfg.tower_dim, out_ch, 1)) for _ in range(n_stacks)])
    return nn.ModuleList([nn.Conv2d(in_ch, out_ch, 1)
                          for _ in range(n_stacks)])


class HeatmapHeads(nn.Module):
    def __init__(self, cfg: HeadsConfig, in_ch: int, n_stacks: int):
        super().__init__()
        self.hp_convs = _convs(cfg, in_ch, cfg.n_keypoints, n_stacks)
        if cfg.include_background:
            self.bghp_convs = _convs(cfg, in_ch, 1, n_stacks)
        if cfg.include_jitter_offset:
            self.jitter_convs = _convs(cfg, in_ch, 2, n_stacks)


class OffsetHeads(nn.Module):
    def __init__(self, cfg: HeadsConfig, in_ch: int, n_stacks: int):
        super().__init__()
        self.reg_convs = _convs(cfg, in_ch, 2 * cfg.n_limbs, n_stacks)
        if cfg.include_spread:
            self.spread_convs = _convs(cfg, in_ch, cfg.n_limbs, n_stacks)
        if cfg.include_scale:
            self.scale_convs = _convs(cfg, in_ch, cfg.n_keypoints, n_stacks)


class PoseHeads(nn.ModuleList):
    """`[HeatmapHeads, OffsetHeads]`; the 1x1 heads run fused."""

    def __init__(self, cfg: HeadsConfig, in_ch: int, n_stacks: int):
        super().__init__([HeatmapHeads(cfg, in_ch, n_stacks),
                          OffsetHeads(cfg, in_ch, n_stacks)])
        self.tower = cfg.tower

    def _spec(self):
        h0, h1 = self[0], self[1]
        return (('hmp', h0, 'hp_convs'), ('bg', h0, 'bghp_convs'),
                ('jomp', h0, 'jitter_convs'), ('omp', h1, 'reg_convs'),
                ('spread', h1, 'spread_convs'), ('scmp', h1, 'scale_convs'))

    def forward(self, feats: List[torch.Tensor]) -> Dict[str, list]:
        out = {k: [] for k in HEAD_KEYS}
        spec = self._spec()
        for s, f in enumerate(feats):
            convs = [(key, getattr(mod, attr)[s] if hasattr(mod, attr)
                      else None) for key, mod, attr in spec]
            if self.tower:
                x = f.float()
                for key, c in convs:
                    out[key].append(None if c is None
                                    else c(x).permute(0, 2, 3, 1))
                continue
            live = [c for _, c in convs if c is not None]
            w = torch.cat([c.weight.reshape(c.out_channels, -1)
                           for c in live]).float()          # (Ctot, Cin)
            b = torch.cat([c.bias for c in live]).float()
            x = f.float().permute(0, 2, 3, 1)               # NHWC
            y = torch.matmul(x, w.t()) + b
            o = 0
            for key, c in convs:
                if c is None:
                    out[key].append(None)
                else:
                    out[key].append(y[..., o:o + c.out_channels])
                    o += c.out_channels
        return out
