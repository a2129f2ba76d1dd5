"""The plain Hourglass-104 pose network, written from its parameter names.

Hourglass-104 as CornerNet / CenterNet's `exkp` defines it and as the
reference repository's `models/hourglass_104.py` builds it: a 7x7 stride-2
conv-BN-ReLU stem and a stride-2 residual to stride 4, `n_stacks`
recursive hourglass modules over `dims` / `modules` (downsampling by the
first stride-2 residual of each `low1`, nearest x2 upsampling), a 3x3
conv-BN-ReLU after each stack, and the inter-stack fusion relu(1x1BN(inter)
+ 1x1BN(cnv)) -> residual. The heads are 1x1 convolutions with bias over
each stack's features: heatmaps (J), background (1), jitter offsets (2),
guiding offsets (2L), keypoint scales (J).

The network is a function of a flat state dict whose keys are the
reference layout (`basenet.pre.0.conv.weight`, `headnets.0.hp_convs.0.bias`,
...), so the weights the benchmark makes load into the port with
`strict=True`. Everything runs in float32 with BatchNorm unfolded, unless
`fp8` asks for the control: every backbone convolution's input and weight
rounded to float8 e4m3 with one scale a tensor (its largest magnitude to
448), computed in float32; the heads stay float32. Nothing here imports
the port.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
HEADS = (('hmp', 'headnets.0.hp_convs'), ('bg', 'headnets.0.bghp_convs'),
         ('jomp', 'headnets.0.jitter_convs'), ('omp', 'headnets.1.reg_convs'),
         ('scmp', 'headnets.1.scale_convs'))

Spec = Tuple[str, Tuple[int, ...], str]     # key, shape, kind


def param_specs(cfg: Dict) -> List[Spec]:
    """Every state-dict entry of the network of config `cfg`: (key, shape,
    kind), kind one of conv, head_w, head_b, bn_w, bn_b, bn_mean, bn_var,
    bn_count."""
    out: List[Spec] = []

    def conv(p, cin, cout, k):
        out.append((f'{p}.weight', (cout, cin, k, k), 'conv'))

    def bn(p, c):
        out.extend([(f'{p}.weight', (c,), 'bn_w'), (f'{p}.bias', (c,), 'bn_b'),
                    (f'{p}.running_mean', (c,), 'bn_mean'),
                    (f'{p}.running_var', (c,), 'bn_var'),
                    (f'{p}.num_batches_tracked', (), 'bn_count')])

    def residual(p, cin, cout, stride=1):
        conv(f'{p}.conv1', cin, cout, 3)
        bn(f'{p}.bn1', cout)
        conv(f'{p}.conv2', cout, cout, 3)
        bn(f'{p}.bn2', cout)
        if stride != 1 or cin != cout:
            conv(f'{p}.skip.0', cin, cout, 1)
            bn(f'{p}.skip.1', cout)

    def kp(p, n, dims, modules, in_dim):
        curr, nxt = dims[0], dims[1]
        cm, nm = modules[0], modules[1]
        for m in range(cm):
            residual(f'{p}.up1.{m}', in_dim if m == 0 else curr, curr)
        residual(f'{p}.low1.0', in_dim, nxt, 2)
        for m in range(1, cm):
            residual(f'{p}.low1.{m}', nxt, nxt)
        if n > 1:
            kp(f'{p}.low2', n - 1, dims[1:], modules[1:], nxt)
        else:
            for m in range(nm):
                residual(f'{p}.low2.{m}', nxt, nxt)
        for m in range(cm - 1):
            residual(f'{p}.low3.{m}', nxt, nxt)
        residual(f'{p}.low3.{cm - 1}', nxt, curr)

    dims, modules = cfg['dims'], cfg['modules']
    S, cnv = cfg['n_stacks'], cfg['cnv_dim']
    conv('basenet.pre.0.conv', 3, 128, 7)
    bn('basenet.pre.0.bn', 128)
    residual('basenet.pre.1', 128, 256, 2)
    for s in range(S):
        kp(f'basenet.kps.{s}', cfg['hg_order'], dims, modules, 256)
        conv(f'basenet.cnvs.{s}.conv', dims[0], cnv, 3)
        bn(f'basenet.cnvs.{s}.bn', cnv)
    for s in range(S - 1):
        conv(f'basenet.inters_.{s}.0', 256, 256, 1)
        bn(f'basenet.inters_.{s}.1', 256)
        conv(f'basenet.cnvs_.{s}.0', cnv, 256, 1)
        bn(f'basenet.cnvs_.{s}.1', 256)
        residual(f'basenet.inters.{s}', 256, 256)
    J, L = len(cfg['keypoints']), len(cfg['skeleton'])
    widths = {'hmp': J, 'bg': 1, 'jomp': 2, 'omp': 2 * L, 'scmp': J}
    for name, prefix in HEADS:
        for s in range(S):
            out.append((f'{prefix}.{s}.weight', (widths[name], cnv, 1, 1),
                        'head_w'))
            out.append((f'{prefix}.{s}.bias', (widths[name],), 'head_b'))
    return out


@torch.no_grad()
def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded weights on `device`, drawn by one generator there in one
    call: He-scaled convolutions, head biases of std 0.1, BatchNorm scale
    1 + 0.1 N and offset 0.1 N, the scale of the last BatchNorm of every
    residual branch (`bn2`) times the config's `init_residual_gain` (the
    small-gamma start of Goyal et al. 2017: without it the seeded
    104-layer network is chaotic, and bf16 rounding alone moves its maps
    by a third). Running statistics are zero mean and unit variance until
    `calibrate_` sets them."""
    specs = param_specs(cfg)
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
        if kind in ('conv', 'head_w'):
            t.mul_(math.sqrt(2.0 / math.prod(shape[1:])))
        elif kind == 'bn_w':
            t.mul_(0.1).add_(1.0)
            if key.endswith('.bn2.weight'):
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
        self._calib: Optional[Dict[str, torch.Tensor]] = None

    # -- layers -------------------------------------------------------------
    def _conv(self, x, p, stride=1):
        w = self.sd[f'{p}.weight']
        if self.fp8:
            x, w = _q8(x), _q8(w)
        return F.conv2d(x, w, stride=stride, padding=(w.shape[-1] - 1) // 2)

    def _bn(self, x, p):
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

    def _residual(self, x, p, stride=1):
        y = torch.relu(self._bn(self._conv(x, f'{p}.conv1', stride),
                                f'{p}.bn1'))
        y = self._bn(self._conv(y, f'{p}.conv2'), f'{p}.bn2')
        if f'{p}.skip.0.weight' in self.sd:
            x = self._bn(self._conv(x, f'{p}.skip.0', stride), f'{p}.skip.1')
        return torch.relu(y + x)

    def _seq(self, x, p, n, first_stride=1):
        for m in range(n):
            x = self._residual(x, f'{p}.{m}', first_stride if m == 0 else 1)
        return x

    def _kp(self, x, p, n, modules):
        cm, nm = modules[0], modules[1]
        up = self._seq(x, f'{p}.up1', cm)
        low = self._seq(x, f'{p}.low1', cm, 2)
        low = (self._kp(low, f'{p}.low2', n - 1, modules[1:]) if n > 1
               else self._seq(low, f'{p}.low2', nm))
        low = self._seq(low, f'{p}.low3', cm)
        return up + F.interpolate(low, scale_factor=2, mode='nearest')

    # -- network ------------------------------------------------------------
    def backbone(self, x) -> List[torch.Tensor]:
        cfg = self.cfg
        inter = torch.relu(self._bn(self._conv(x, 'basenet.pre.0.conv', 2),
                                    'basenet.pre.0.bn'))
        inter = self._residual(inter, 'basenet.pre.1', 2)
        outs = []
        S = cfg['n_stacks']
        for s in range(S):
            y = self._kp(inter, f'basenet.kps.{s}', cfg['hg_order'],
                         cfg['modules'])
            y = torch.relu(self._bn(self._conv(y, f'basenet.cnvs.{s}.conv'),
                                    f'basenet.cnvs.{s}.bn'))
            outs.append(y)
            if s < S - 1:
                a = self._bn(self._conv(inter, f'basenet.inters_.{s}.0'),
                             f'basenet.inters_.{s}.1')
                b = self._bn(self._conv(y, f'basenet.cnvs_.{s}.0'),
                             f'basenet.cnvs_.{s}.1')
                inter = self._residual(torch.relu(a + b),
                                       f'basenet.inters.{s}')
        return outs

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
