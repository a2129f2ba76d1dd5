"""Forward FLOPs of the network, counted on the benchmark's own plain copy.

`torch.utils.flop_counter.FlopCounterMode` over one image's forward of
`reference.model.PlainPoseNet` on the meta device (no memory, no
compute): 2 FLOPs a multiply-accumulate of every convolution and Linear
layer, the heads' included. The port's modules are never counted, so a
change to the port's model code cannot change the yardstick.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference.model import PlainPoseNet, param_specs


def forward_flops(cfg: Dict, h: int, w: int) -> int:
    """FLOPs of one image's forward at network-input size h x w."""
    sd = {key: torch.empty(shape, device='meta',
                           dtype=torch.long if kind == 'bn_count'
                           else torch.float32)
          for key, shape, kind in param_specs(cfg)}
    model = PlainPoseNet(cfg, sd)
    x = torch.empty((1, h, w, 3), device='meta')
    with FlopCounterMode(display=False) as counter:
        model.heads(model.backbone(x.permute(0, 3, 1, 2)))
    return int(counter.get_total_flops())


def n_params(cfg: Dict) -> int:
    return sum(math.prod(shape) for _, shape, kind in param_specs(cfg)
               if kind not in ('bn_mean', 'bn_var', 'bn_count'))
