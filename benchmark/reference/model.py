"""The plain pose network: a backbone named by the configuration, and the
heads.

A configuration's `basenet` names its backbone, found by name as
`nets/<basenet>.py` (the interface is in `nets/__init__.py`), as a traffic
mix's `entry` names its runner. The heads are 1x1 convolutions with bias
over each stack's features: heatmaps (J), background (1), jitter offsets
(2), guiding offsets (2L), keypoint scales (J).

The network is a function of a flat state dict whose keys are the port's
layout (`basenet....`, `headnets.0.hp_convs.0.bias`, ...), so the weights
the benchmark makes load into the port with `strict=True`. Everything runs
in float32 with BatchNorm unfolded, unless `fp8` asks for the control:
every backbone convolution's input and weight rounded to float8 e4m3 with
one scale a tensor (its largest magnitude to 448), computed in float32;
the heads, and any Linear layer of a backbone, stay float32. Nothing here
imports the port.
"""
from __future__ import annotations

import contextlib
import importlib
import math
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
HEADS = (('hmp', 'headnets.0.hp_convs'), ('bg', 'headnets.0.bghp_convs'),
         ('jomp', 'headnets.0.jitter_convs'), ('omp', 'headnets.1.reg_convs'),
         ('scmp', 'headnets.1.scale_convs'))
NETS = Path(__file__).resolve().parent / 'nets'

Spec = Tuple[str, Tuple[int, ...], str]     # key, shape, kind


class Specs(list):
    """State-dict entries (key, shape, kind) in the order they are drawn;
    a backbone's `specs` appends its own through these."""

    def conv(self, p, cin, cout, k):
        self.append((f'{p}.weight', (cout, cin, k, k), 'conv'))

    def bn(self, p, c):
        self.extend([(f'{p}.weight', (c,), 'bn_w'),
                     (f'{p}.bias', (c,), 'bn_b'),
                     (f'{p}.running_mean', (c,), 'bn_mean'),
                     (f'{p}.running_var', (c,), 'bn_var'),
                     (f'{p}.num_batches_tracked', (), 'bn_count')])

    def linear(self, p, cin, cout):
        self.extend([(f'{p}.weight', (cout, cin), 'lin_w'),
                     (f'{p}.bias', (cout,), 'lin_b')])


def network(cfg: Dict) -> ModuleType:
    """The plain backbone the configuration's `basenet` names."""
    name = cfg['basenet']
    path = NETS / f'{name}.py'
    if not path.is_file():
        raise FileNotFoundError(
            f'no plain network for basenet {name!r}: {path} is missing')
    return importlib.import_module(f'{__package__}.nets.{name}')


def param_specs(cfg: Dict) -> List[Spec]:
    """Every state-dict entry of the network of config `cfg`: (key, shape,
    kind), kind one of conv, lin_w, lin_b, head_w, head_b, bn_w, bn_b,
    bn_mean, bn_var, bn_count."""
    net = network(cfg)
    out = Specs()
    net.specs(cfg, out)
    S, feat = cfg['n_stacks'], net.feat_dim(cfg)
    J, L = len(cfg['keypoints']), len(cfg['skeleton'])
    widths = {'hmp': J, 'bg': 1, 'jomp': 2, 'omp': 2 * L, 'scmp': J}
    for name, prefix in HEADS:
        for s in range(S):
            out.append((f'{prefix}.{s}.weight', (widths[name], feat, 1, 1),
                        'head_w'))
            out.append((f'{prefix}.{s}.bias', (widths[name],), 'head_b'))
    return out


@torch.no_grad()
def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded weights on `device`, drawn by one generator there in one
    call: He-scaled convolution and Linear weights, head and Linear biases
    of std 0.1, BatchNorm scale 1 + 0.1 N and offset 0.1 N, the scale of
    the last BatchNorm of every residual branch (as the backbone's
    `ends_branch` says) times the config's `init_residual_gain` (the
    small-gamma start of Goyal et al. 2017: without it the seeded
    104-layer network is chaotic, and bf16 rounding alone moves its maps
    by a third). Running statistics are zero mean and unit variance until
    `calibrate_` sets them."""
    specs = param_specs(cfg)
    ends_branch = network(cfg).ends_branch
    drawn = [s for s in specs if s[2] not in ('bn_mean', 'bn_var',
                                              'bn_count')]
    total = sum(math.prod(shape) for _, shape, _ in drawn)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    gain = float(cfg.get('init_residual_gain', 1.0))
    sd, o = {}, 0
    for key, shape, kind in specs:
        if kind == 'bn_mean':
            sd[key] = torch.zeros(shape, device=device)
            continue
        if kind == 'bn_var':
            sd[key] = torch.ones(shape, device=device)
            continue
        if kind == 'bn_count':
            sd[key] = torch.zeros(shape, dtype=torch.long, device=device)
            continue
        n = math.prod(shape)
        t = flat[o:o + n].view(shape)
        o += n
        if kind in ('conv', 'head_w', 'lin_w'):
            t.mul_(math.sqrt(2.0 / math.prod(shape[1:])))
        elif kind == 'bn_w':
            t.mul_(0.1).add_(1.0)
            if ends_branch(key):
                t.mul_(gain)
        else:
            t.mul_(0.1)
        sd[key] = t
    return sd


def _q8(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale for the tensor, back to fp32."""
    amax = t.abs().amax().clamp(min=1e-12)
    s = 448.0 / amax
    return (t * s).to(torch.float8_e4m3fn).float() / s


class PlainPoseNet:
    """The network over a state dict. `forward(images)` takes NHWC float
    images (normalized) and returns the heads' per-stack fp32 NHWC maps,
    the dict the port's `PoseNet` returns."""

    def __init__(self, cfg: Dict, sd: Dict[str, torch.Tensor],
                 fp8: bool = False):
        self.cfg, self.sd, self.fp8 = cfg, sd, fp8
        self._backbone = network(cfg)
        self._calib: Optional[Dict[str, torch.Tensor]] = None

    # -- layers the backbones are written in --------------------------------
    def conv(self, x, p, stride=1, dilation=1):
        w = self.sd[f'{p}.weight']
        if self.fp8:
            x, w = _q8(x), _q8(w)
        return F.conv2d(x, w, stride=stride,
                        padding=dilation * (w.shape[-1] - 1) // 2,
                        dilation=dilation)

    def bn(self, x, p):
        sd = self.sd
        if self._calib is not None:
            mean = x.mean(dim=(0, 2, 3))
            var = (x * x).mean(dim=(0, 2, 3)) - mean * mean
            self._calib[f'{p}.running_mean'] = mean
            self._calib[f'{p}.running_var'] = var
        else:
            mean, var = sd[f'{p}.running_mean'], sd[f'{p}.running_var']
        s = sd[f'{p}.weight'] * torch.rsqrt(var + BN_EPS)
        return (x - mean[:, None, None]) * s[:, None, None] \
            + sd[f'{p}.bias'][:, None, None]

    def linear(self, x, p):
        return F.linear(x, self.sd[f'{p}.weight'], self.sd[f'{p}.bias'])

    # -- network ------------------------------------------------------------
    def backbone(self, x) -> List[torch.Tensor]:
        """NCHW fp32 images -> the per-stack NCHW features."""
        return self._backbone.backbone(self, x)

    def heads(self, feats) -> Dict[str, list]:
        out = {'hmp': [], 'bg': [], 'jomp': [], 'omp': [], 'spread': [],
               'scmp': []}
        for s, f in enumerate(feats):
            for name, prefix in HEADS:
                y = F.conv2d(f.float(), self.sd[f'{prefix}.{s}.weight'],
                             self.sd[f'{prefix}.{s}.bias'])
                out[name].append(y.permute(0, 2, 3, 1))
            out['spread'].append(None)
        return out

    @torch.no_grad()
    def forward(self, images: torch.Tensor) -> Dict[str, list]:
        with fp32_exact():
            x = images.float().permute(0, 3, 1, 2).contiguous()
            return self.heads(self.backbone(x))

    __call__ = forward

    def parameters(self):
        """The device of the weights, as `next(model.parameters())` reads
        it."""
        return iter(self.sd.values())

    @torch.no_grad()
    def calibrate_(self, images: torch.Tensor) -> None:
        """Set every BatchNorm's running statistics to the batch statistics
        (mean, biased variance) of one forward over `images` (NHWC,
        normalized), so the seeded weights give activations of unit scale
        at every depth, at the size the cell serves."""
        self._calib = {}
        try:
            with fp32_exact():
                self.backbone(images.float().permute(0, 3, 1, 2).contiguous())
            self.sd.update(self._calib)
        finally:
            self._calib = None
        for k in self.sd:
            if k.endswith('num_batches_tracked'):
                self.sd[k].fill_(1)


def normalize(images: torch.Tensor, mean, std) -> torch.Tensor:
    """(N, H, W, 3) uint8 RGB -> normalized float32."""
    m = torch.tensor(mean, dtype=torch.float32, device=images.device)
    s = torch.tensor(std, dtype=torch.float32, device=images.device)
    return (images.float() / 255.0 - m) / s


@contextlib.contextmanager
def fp32_exact():
    """Full float32 convolutions and matmuls on the card (no TF32)."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
