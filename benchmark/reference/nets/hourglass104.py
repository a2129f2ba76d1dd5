"""Hourglass-104, as CornerNet / CenterNet's `exkp` defines it and as the
reference repository's `models/hourglass_104.py` builds it.

A 7x7 stride-2 conv-BN-ReLU stem and a stride-2 residual to stride 4,
`n_stacks` recursive hourglass modules over `dims` / `modules`
(downsampling by the first stride-2 residual of each `low1`, nearest x2
upsampling), a 3x3 conv-BN-ReLU after each stack, and the inter-stack
fusion relu(1x1BN(inter) + 1x1BN(cnv)) -> residual. Each `BasicResidual`
is two 3x3 conv-BNs, ReLU between and after the add; its branch ends in
`bn2`.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F


def feat_dim(cfg: Dict) -> int:
    return cfg['cnv_dim']


def ends_branch(key: str) -> bool:
    return key.endswith('.bn2.weight')


def _residual_specs(out, p, cin, cout, stride=1):
    out.conv(f'{p}.conv1', cin, cout, 3)
    out.bn(f'{p}.bn1', cout)
    out.conv(f'{p}.conv2', cout, cout, 3)
    out.bn(f'{p}.bn2', cout)
    if stride != 1 or cin != cout:
        out.conv(f'{p}.skip.0', cin, cout, 1)
        out.bn(f'{p}.skip.1', cout)


def _kp_specs(out, p, n, dims, modules, in_dim):
    curr, nxt = dims[0], dims[1]
    cm, nm = modules[0], modules[1]
    for m in range(cm):
        _residual_specs(out, f'{p}.up1.{m}', in_dim if m == 0 else curr, curr)
    _residual_specs(out, f'{p}.low1.0', in_dim, nxt, 2)
    for m in range(1, cm):
        _residual_specs(out, f'{p}.low1.{m}', nxt, nxt)
    if n > 1:
        _kp_specs(out, f'{p}.low2', n - 1, dims[1:], modules[1:], nxt)
    else:
        for m in range(nm):
            _residual_specs(out, f'{p}.low2.{m}', nxt, nxt)
    for m in range(cm - 1):
        _residual_specs(out, f'{p}.low3.{m}', nxt, nxt)
    _residual_specs(out, f'{p}.low3.{cm - 1}', nxt, curr)


def specs(cfg: Dict, out) -> None:
    dims, modules = cfg['dims'], cfg['modules']
    S, cnv = cfg['n_stacks'], cfg['cnv_dim']
    out.conv('basenet.pre.0.conv', 3, 128, 7)
    out.bn('basenet.pre.0.bn', 128)
    _residual_specs(out, 'basenet.pre.1', 128, 256, 2)
    for s in range(S):
        _kp_specs(out, f'basenet.kps.{s}', cfg['hg_order'], dims, modules, 256)
        out.conv(f'basenet.cnvs.{s}.conv', dims[0], cnv, 3)
        out.bn(f'basenet.cnvs.{s}.bn', cnv)
    for s in range(S - 1):
        out.conv(f'basenet.inters_.{s}.0', 256, 256, 1)
        out.bn(f'basenet.inters_.{s}.1', 256)
        out.conv(f'basenet.cnvs_.{s}.0', cnv, 256, 1)
        out.bn(f'basenet.cnvs_.{s}.1', 256)
        _residual_specs(out, f'basenet.inters.{s}', 256, 256)


def _residual(net, x, p, stride=1):
    y = torch.relu(net.bn(net.conv(x, f'{p}.conv1', stride), f'{p}.bn1'))
    y = net.bn(net.conv(y, f'{p}.conv2'), f'{p}.bn2')
    if f'{p}.skip.0.weight' in net.sd:
        x = net.bn(net.conv(x, f'{p}.skip.0', stride), f'{p}.skip.1')
    return torch.relu(y + x)


def _seq(net, x, p, n, first_stride=1):
    for m in range(n):
        x = _residual(net, x, f'{p}.{m}', first_stride if m == 0 else 1)
    return x


def _kp(net, x, p, n, modules):
    cm, nm = modules[0], modules[1]
    up = _seq(net, x, f'{p}.up1', cm)
    low = _seq(net, x, f'{p}.low1', cm, 2)
    low = (_kp(net, low, f'{p}.low2', n - 1, modules[1:]) if n > 1
           else _seq(net, low, f'{p}.low2', nm))
    low = _seq(net, low, f'{p}.low3', cm)
    return up + F.interpolate(low, scale_factor=2, mode='nearest')


def backbone(net, x) -> List[torch.Tensor]:
    cfg = net.cfg
    inter = torch.relu(net.bn(net.conv(x, 'basenet.pre.0.conv', 2),
                              'basenet.pre.0.bn'))
    inter = _residual(net, inter, 'basenet.pre.1', 2)
    outs = []
    S = cfg['n_stacks']
    for s in range(S):
        y = _kp(net, inter, f'basenet.kps.{s}', cfg['hg_order'],
                cfg['modules'])
        y = torch.relu(net.bn(net.conv(y, f'basenet.cnvs.{s}.conv'),
                              f'basenet.cnvs.{s}.bn'))
        outs.append(y)
        if s < S - 1:
            a = net.bn(net.conv(inter, f'basenet.inters_.{s}.0'),
                       f'basenet.inters_.{s}.1')
            b = net.bn(net.conv(y, f'basenet.cnvs_.{s}.0'),
                       f'basenet.cnvs_.{s}.1')
            inter = _residual(net, torch.relu(a + b), f'basenet.inters.{s}')
    return outs
