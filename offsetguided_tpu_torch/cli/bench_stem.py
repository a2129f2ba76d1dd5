#!/usr/bin/env python
"""Stem convolution formulations, compared on the card.

Port of the JAX package's `cli/bench_stem.py` with its flags and variant
names, plus `--device` (the card unless told otherwise). The 7x7
stride-2 stem on the 3-channel image is the forward's one convolution
far from the tensor cores' rate (a contraction over 147 inputs). Each
formulation computes conv + bias + ReLU in PyTorch:

  plain   -- the strided 7x7 convolution (cuDNN).
  wfold   -- W-parity pairs folded into channels (6 channels, kernel
             zero-padded to 8x8 and folded by W parity), stride (2, 1).
  full    -- 2x2 space-to-depth, a stride-1 4x4 convolution on 12
             channels.
  im2col  -- the patch tensor from 49 strided slices and one concat, then
             one (N*Ho*Wo, 147) @ (147, F) matmul.
  patches -- `F.unfold` + matmul (the same math, PyTorch's own patch
             extraction).

Images are (N, 3, H, W) tensors and kernels (F, 3, 7, 7), PyTorch's
layout (the JAX package's NHWC / HWIO arrays transposed). Every variant
is checked against `plain` before it is timed (largest |difference| over
the largest |plain| within `TOLERANCE` of the dtype), in `--dtype` (the
forward's bf16 by default), with the image in NCHW and in channels_last
memory format. Times are CUDA events on the card.

    python -m offsetguided_tpu_torch.cli.bench_stem [--batch 8 --size 640]
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

P = 3                                   # torch padding of the 7x7 stem
# largest |variant - plain| over the largest |plain| a variant may reach:
# a few roundings of the output dtype
TOLERANCE = {torch.bfloat16: 2e-2, torch.float16: 4e-3, torch.float32: 1e-5}


def _bias_relu(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return torch.relu(y + bias[:, None, None])


def stem_plain(x, kernel, bias):
    return _bias_relu(F.conv2d(x, kernel, stride=2, padding=P), bias)


def _padded_kernel(kernel):
    """(F, C, 8, 8): the 7x7 taps zero-padded by one at the front (tap a
    of the padded kernel reads input 2p + a - 4)."""
    return F.pad(kernel, (1, 0, 1, 0))


def stem_wfold(x, kernel, bias):
    n, c, h, w = x.shape
    f = kernel.shape[0]
    xs = x.reshape(n, c, h, w // 2, 2).permute(0, 4, 1, 2, 3).reshape(
        n, 2 * c, h, w // 2)                   # channel dw * C + ci
    kk = _padded_kernel(kernel).reshape(f, c, 8, 4, 2).permute(
        0, 4, 1, 2, 3).reshape(f, 2 * c, 8, 4)
    xs = F.pad(xs, (2, 1, 4, 2))               # W (lo, hi), H (P + 1, 2)
    return _bias_relu(F.conv2d(xs, kk, stride=(2, 1)), bias)


def stem_full(x, kernel, bias):
    n, c, h, w = x.shape
    f = kernel.shape[0]
    xs = x.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    xs = xs.reshape(n, 4 * c, h // 2, w // 2)  # channel (dh*2 + dw)*C + ci
    kk = _padded_kernel(kernel).reshape(f, c, 4, 2, 4, 2).permute(
        0, 3, 5, 1, 2, 4).reshape(f, 4 * c, 4, 4)
    return _bias_relu(F.conv2d(F.pad(xs, (2, 1, 2, 1)), kk), bias)


def stem_im2col(x, kernel, bias):
    n, c, h, w = x.shape
    f = kernel.shape[0]
    xp = F.pad(x, (P, P + 1, P, P + 1))
    cols = [xp[:, :, dy:dy + h:2, dx:dx + w:2]
            for dy in range(7) for dx in range(7)]
    patches = torch.cat(cols, dim=1)                  # (N, 49*C, Ho, Wo)
    kmat = kernel.permute(0, 2, 3, 1).reshape(f, -1)  # (F, 49*C): dy, dx, c
    y = torch.matmul(patches.permute(0, 2, 3, 1), kmat.t())
    return _bias_relu(y.permute(0, 3, 1, 2), bias)


def stem_patches(x, kernel, bias):
    n, c, h, w = x.shape
    f = kernel.shape[0]
    cols = F.unfold(x, 7, padding=P, stride=2)        # (N, C*49, L): c, ky, kx
    y = torch.matmul(kernel.reshape(f, -1), cols)     # (N, F, L)
    return _bias_relu(y.reshape(n, f, h // 2, w // 2), bias)


VARIANTS = {'plain': stem_plain, 'wfold': stem_wfold, 'full': stem_full,
            'im2col': stem_im2col, 'patches': stem_patches}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--size', type=int, default=640)
    ap.add_argument('--features', type=int, default=128)
    ap.add_argument('--dtype', default='bfloat16')
    ap.add_argument('--from-f32', action='store_true',
                    help='feed an f32 image and cast inside the timed call '
                         '(the real normalize -> stem hand-off)')
    ap.add_argument('--device', default=None,
                    help='torch device (default: the card)')
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..utils.profiling import device_time

    dev = resolve_device(args.device)
    dt = getattr(torch, args.dtype)
    rng = np.random.RandomState(0)
    img32 = rng.randn(args.batch, args.size, args.size, 3).astype(np.float32)
    kernel = torch.from_numpy(
        rng.randn(7, 7, 3, args.features).astype(np.float32) * 0.05)
    bias = torch.from_numpy(rng.randn(args.features).astype(np.float32))
    kernel = kernel.permute(3, 2, 0, 1).contiguous().to(dev, dt)  # HWIO->OIHW
    bias = bias.to(dev, dt)
    x_nchw = torch.from_numpy(img32).to(dev).permute(0, 3, 1, 2)
    flops = args.batch * (args.size // 2) ** 2 * args.features * 147 * 2

    result = {'dtype': args.dtype, 'ms': {}, 'max_abs_err': {}, 'ok': {},
              'device': (torch.cuda.get_device_name(dev)
                         if dev.type == 'cuda' else str(dev))}
    for layout, fmt in (('nchw', torch.contiguous_format),
                        ('channels_last', torch.channels_last)):
        x = x_nchw.contiguous(memory_format=fmt)
        x = x if args.from_f32 else x.to(dt)
        ref = None
        for name, fn in VARIANTS.items():
            def call(xx, fn=fn):
                return fn(xx.to(dt), kernel, bias)
            with torch.no_grad():
                out = call(x).float()
                if ref is None:
                    ref = out
                err = float((out - ref).abs().max())
                ok = err <= TOLERANCE[dt] * float(ref.abs().max())
                t = device_time(torch.no_grad()(call), x)
            key = f'{name}/{layout}'
            result['ms'][key] = t * 1e3
            result['max_abs_err'][key] = err
            result['ok'][key] = ok
            print(f'{name:8s} {layout:13s} {t * 1e3:7.3f} ms   '
                  f'{flops / t / 1e12:6.1f} TF/s   max|d|={err:.3e}'
                  + ('' if ok else '   DIFFERS FROM plain'))
    return result


if __name__ == '__main__':
    main()
