"""PoseNet: backbone + heads, with the reference `basenet.`/`headnets.` split.

`PoseNet(images)` takes NHWC float images and returns the heads' dict of
per-stack fp32 NHWC prediction maps, like the JAX package's `PoseNet.apply`.
In train mode the backbone runs under autocast in `cfg.compute_dtype` with
fp32 parameters and fp32 BatchNorm statistics (the JAX package's
`compute_dtype='bfloat16'`, `param_dtype='float32'` policy); the heads stay
fp32.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List

import torch
from torch import nn

from ..config.defaults import ModelConfig
from ..device import resolve_device
from .heads import PoseHeads
from .hourglass104 import Hourglass104
from .hourglass4stage import Hourglass4Stage
from ..ops.image import normalize_images
from .layers import BatchNorm2d, fold_batchnorm


def backbone_config(cfg: ModelConfig) -> ModelConfig:
    """The backbone config a `basenet` name stands for (`hourglass52` is
    the single-stack Hourglass104)."""
    if cfg.basenet in ('hourglass104', 'hourglass4stage'):
        return cfg
    if cfg.basenet == 'hourglass52':
        return dataclasses.replace(cfg, n_stacks=1)
    raise ValueError(f'unknown basenet: {cfg.basenet}')


def basenet_factory(cfg: ModelConfig) -> nn.Module:
    """The backbone; its `feat_dim` is the width of its per-stack features
    (`cnv_dim` for Hourglass104, 256 for the 4-stage net)."""
    bcfg = backbone_config(cfg)
    if bcfg.basenet == 'hourglass4stage':
        return Hourglass4Stage(bcfg)
    return Hourglass104(bcfg)


class PoseNet(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        self.basenet = basenet_factory(cfg)
        self.headnets = PoseHeads(cfg.heads, self.basenet.feat_dim,
                                  backbone_config(cfg).n_stacks)
        for m in self.modules():
            if isinstance(m, BatchNorm2d):     # torch convention: 1 - JAX's
                m.momentum = 1.0 - cfg.bn_momentum

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    def autocast(self, device_type: str):
        """Autocast to the compute dtype where the backbone's parameters
        are of a wider type (fp32 parameters, bf16 compute); else a no-op
        context."""
        dtype = next(self.basenet.parameters()).dtype
        if self.compute_dtype.itemsize >= dtype.itemsize:
            return contextlib.nullcontext()
        return torch.autocast(device_type, dtype=self.compute_dtype)

    def forward(self, images: torch.Tensor) -> Dict[str, List]:
        """(N, H, W, 3) float images -> per-stack fp32 NHWC maps. In eval
        mode the backbone runs in the dtype of its parameters, in train
        mode under `autocast`."""
        dtype = next(self.basenet.parameters()).dtype
        x = images.permute(0, 3, 1, 2).to(
            dtype=dtype, memory_format=torch.channels_last)
        ctx = (self.autocast(x.device.type) if self.training
               else contextlib.nullcontext())
        with ctx:
            feats = self.basenet(x)
        return self.headnets(feats)

    def prepare_inference(self) -> 'PoseNet':
        """Eval mode, BatchNorm folded into the convs, backbone in the
        compute dtype and channels_last; heads stay fp32."""
        self.eval()
        fold_batchnorm(self.basenet)
        self.basenet.to(dtype=self.compute_dtype,
                        memory_format=torch.channels_last)
        return self


@torch.no_grad()
def init_he_(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights that keep a deep forward in range: He-scaled
    conv and Linear (squeeze-and-excitation) weights, small biases,
    BatchNorm statistics with variance >= 0.5. Drawn on the CPU from one
    `torch.Generator`, so a seed gives the same weights on every device."""
    g = torch.Generator().manual_seed(seed)

    def draw(t, scale, shift=0.0):
        t.copy_(torch.randn(t.shape, generator=g) * scale + shift)

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            draw(m.weight, (2.0 / m.weight[0].numel()) ** 0.5)
            if m.bias is not None:
                draw(m.bias, 0.1)
        elif isinstance(m, nn.BatchNorm2d):
            draw(m.weight, 0.1, 1.0)
            draw(m.bias, 0.1)
            draw(m.running_mean, 0.1)
            m.running_var.copy_(torch.rand(m.running_var.shape,
                                           generator=g) + 0.5)
    return model


@torch.no_grad()
def init_reference_(model: nn.Module, generator: torch.Generator
                    ) -> nn.Module:
    """The JAX trainer's fresh initialization: every conv kernel (heads
    included) drawn from normal(0, 0.001), the squeeze-and-excitation
    Linear weights from flax Dense's default (lecun_normal: a normal of
    std sqrt(1 / fan_in) / 0.8796, truncated at two of its stds), zero
    biases, BatchNorm scale 1 and offset 0, running mean 0 and variance 1.
    Drawn on the CPU from `generator`, so a seed gives the same weights on
    every device."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * 0.001)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            w = torch.randn(m.weight.shape, generator=generator)
            out = w.abs() > 2
            while out.any():
                w[out] = torch.randn(int(out.sum()), generator=generator)
                out = w.abs() > 2
            m.weight.copy_(w * ((1.0 / m.in_features) ** 0.5 / 0.87962566))
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model


@torch.no_grad()
def calibrate_batchnorm_(model: nn.Module, images: torch.Tensor) -> nn.Module:
    """Set every BatchNorm's running statistics to the batch statistics of
    one forward over `images` (NHWC), so random weights give activations of
    unit scale at every depth. Leaves the model in eval mode."""
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    saved = [m.momentum for m in bns]
    model.eval()
    for m in bns:
        m.reset_running_stats()
        m.momentum = None            # cumulative average over this pass
        m.train()
    model(images)
    for m, mom in zip(bns, saved):
        m.momentum = mom
    return model.eval()


def random_posenet(cfg: ModelConfig, seed: int, device=None,
                   calib_size: int = 256, calib_batch: int = 4) -> PoseNet:
    """PoseNet with `init_he_(seed)` weights and BatchNorm statistics
    calibrated on a seeded batch of uint8 noise images: the stand-in for
    trained weights in smoke runs, so heatmaps have peaks and grouping has
    work. Calibrate at the input size the model will serve: at the deepest
    hourglass levels the zero padding sets each conv's gain by the map size,
    and a gain error compounds over the ~100 layers (calibrated at 256^2
    and run at 640^2, Hourglass-104 heads reach 1e4 instead of ~1).
    `device=None` means the card, as in `device.resolve_device`."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.randint(0, 256, (calib_batch, calib_size, calib_size, 3),
                      generator=g, dtype=torch.uint8)
    model = init_he_(PoseNet(cfg), seed).to(device)
    return calibrate_batchnorm_(model, normalize_images(x.to(device)))


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
