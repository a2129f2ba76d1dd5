"""The 4-stage hourglass (IMHN of SimplePose, AAAI'20), as the port's
`models/hourglass4stage.py` and `models/layers.py` build it.

- Stem: a 7x7 stride-2 ConvBN to 64 with LeakyReLU 0.01, a bottleneck to
  128, a 2x2 max-pool, a second bottleneck, then six dilated 3x3 ConvBNs
  with LeakyReLU (dilations 3, 3, 4, 4, 5, 5) whose output is
  concatenated with their input: 256 channels at stride 4.
- `n_stacks` order-4 hourglasses whose width grows by 128 a scale (256
  to 768): down by 2x2 max-pool before `low1`, up by nearest x2.
- Per stack two 3x3 ConvBNs with LeakyReLU, then squeeze-and-excitation:
  the spatial mean in fp32, Linear c -> c/16, ReLU, Linear c/16 -> c,
  sigmoid, channel scale. The stack's features are these 256 channels.
- Between stacks the feedback x + ConvBN1x1(features), no activation.
- Each bottleneck: 1x1 to half width, 3x3 at half, 1x1 to full, each
  with BN, LeakyReLU after the first two and after the add; a projected
  skip (`skip.0` / `skip.1`) where the width changes. Its branch ends in
  `bn3`; the feedback's BN ends a branch too.

The published network's 5-scale deep supervision and its merge layers
are collapsed to the top scale, as in both packages. The float8 control
rounds every convolution; the squeeze-and-excitation Linear layers stay
float32.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

DILATIONS = (3, 3, 4, 4, 5, 5)
DEPTH, FEAT, INCREASE, SE_REDUCTION = 4, 256, 128, 16
LEAKY = 0.01


def feat_dim(cfg: Dict) -> int:
    return FEAT


def ends_branch(key: str) -> bool:
    return key.endswith('.bn3.weight') or (
        key.startswith('basenet.feedback.') and key.endswith('.bn.weight'))


def _conv_bn_specs(out, p, cin, cout, k):
    out.conv(f'{p}.conv', cin, cout, k)
    out.bn(f'{p}.bn', cout)


def _bottleneck_specs(out, p, cin, cout):
    half = cout // 2
    out.conv(f'{p}.conv1', cin, half, 1)
    out.bn(f'{p}.bn1', half)
    out.conv(f'{p}.conv2', half, half, 3)
    out.bn(f'{p}.bn2', half)
    out.conv(f'{p}.conv3', half, cout, 1)
    out.bn(f'{p}.bn3', cout)
    if cin != cout:
        out.conv(f'{p}.skip.0', cin, cout, 1)
        out.bn(f'{p}.skip.1', cout)


def _hourglass_specs(out, p, depth, feat):
    nxt = feat + INCREASE
    _bottleneck_specs(out, f'{p}.up1', feat, feat)
    _bottleneck_specs(out, f'{p}.low1', feat, nxt)
    if depth > 1:
        _hourglass_specs(out, f'{p}.low2', depth - 1, nxt)
    else:
        _bottleneck_specs(out, f'{p}.low2', nxt, nxt)
    _bottleneck_specs(out, f'{p}.low3', nxt, feat)


def specs(cfg: Dict, out) -> None:
    S = cfg['n_stacks']
    _conv_bn_specs(out, 'basenet.stem.conv', 3, 64, 7)
    _bottleneck_specs(out, 'basenet.stem.res1', 64, 128)
    _bottleneck_specs(out, 'basenet.stem.res2', 128, 128)
    for i in range(len(DILATIONS)):
        _conv_bn_specs(out, f'basenet.stem.dilated.{i}', 128, 128, 3)
    for s in range(S):
        _hourglass_specs(out, f'basenet.hgs.{s}', DEPTH, FEAT)
    for s in range(S):
        p = f'basenet.features.{s}'
        _conv_bn_specs(out, f'{p}.0', FEAT, FEAT, 3)
        _conv_bn_specs(out, f'{p}.1', FEAT, FEAT, 3)
        out.linear(f'{p}.2.fc1', FEAT, FEAT // SE_REDUCTION)
        out.linear(f'{p}.2.fc2', FEAT // SE_REDUCTION, FEAT)
    for s in range(S - 1):
        _conv_bn_specs(out, f'basenet.feedback.{s}', FEAT, FEAT, 1)


def _act(x):
    return F.leaky_relu(x, LEAKY)


def _conv_bn(net, x, p, stride=1, dilation=1):
    return net.bn(net.conv(x, f'{p}.conv', stride, dilation), f'{p}.bn')


def _bottleneck(net, x, p):
    y = _act(net.bn(net.conv(x, f'{p}.conv1'), f'{p}.bn1'))
    y = _act(net.bn(net.conv(y, f'{p}.conv2'), f'{p}.bn2'))
    y = net.bn(net.conv(y, f'{p}.conv3'), f'{p}.bn3')
    if f'{p}.skip.0.weight' in net.sd:
        x = net.bn(net.conv(x, f'{p}.skip.0'), f'{p}.skip.1')
    return _act(y + x)


def _hourglass(net, x, p, depth):
    low = _bottleneck(net, F.max_pool2d(x, 2, 2), f'{p}.low1')
    low = (_hourglass(net, low, f'{p}.low2', depth - 1) if depth > 1
           else _bottleneck(net, low, f'{p}.low2'))
    low = _bottleneck(net, low, f'{p}.low3')
    return _bottleneck(net, x, f'{p}.up1') + F.interpolate(
        low, scale_factor=2, mode='nearest')


def _squeeze_excite(net, y, p):
    s = y.float().mean(dim=(2, 3))
    s = torch.sigmoid(net.linear(torch.relu(net.linear(s, f'{p}.fc1')),
                                 f'{p}.fc2'))
    return y * s[:, :, None, None]


def backbone(net, x) -> List[torch.Tensor]:
    x = _act(_conv_bn(net, x, 'basenet.stem.conv', stride=2))
    x = _bottleneck(net, x, 'basenet.stem.res1')
    x = _bottleneck(net, F.max_pool2d(x, 2, 2), 'basenet.stem.res2')
    d = x
    for i, dilation in enumerate(DILATIONS):
        d = _act(_conv_bn(net, d, f'basenet.stem.dilated.{i}',
                          dilation=dilation))
    x = torch.cat([x, d], dim=1)
    outs = []
    S = net.cfg['n_stacks']
    for s in range(S):
        y = _hourglass(net, x, f'basenet.hgs.{s}', DEPTH)
        p = f'basenet.features.{s}'
        y = _act(_conv_bn(net, y, f'{p}.0'))
        y = _act(_conv_bn(net, y, f'{p}.1'))
        y = _squeeze_excite(net, y, f'{p}.2')
        outs.append(y)
        if s < S - 1:
            x = x + _conv_bn(net, y, f'basenet.feedback.{s}')
    return outs
