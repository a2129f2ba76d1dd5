#!/usr/bin/env python
"""Model export and summary: `torch.export` programs, parameter and FLOP
counts, and the reference-format `.pth`.

Port of the JAX package's `cli/export.py` with its flags, plus `--device`
(the card unless told otherwise). It prints the parameters per top module
(`summarize`) and the forward's FLOPs, counted by
`torch.utils.flop_counter.FlopCounterMode` (convolutions and matmuls, two
per multiply-add; the JAX package asks XLA's cost analysis), beside the
reference's thop count of 234.5 GMACs at 512^2. `--to-torch` writes the
weights as a reference-format `.pth` (Hourglass-104 only). `--output`
writes a `torch.export` program (`torch.export.save`, a `.pt2`) of the
forward, or with `--with-decode` of forward + `PostProcessor.decode_body`,
at static shapes (`--batch-size`, `--input-size`): the port's counterpart
of the JAX package's StableHLO export. The program takes normalized float32
NHWC images on the device it was exported on; the decode's kernels appear
in it as the custom ops `offsetguided::peaks_topk` and
`::group_skeletons`, so loading it needs them registered:

    import offsetguided_tpu_torch.ops.cuda  # registers the ops
    program = torch.export.load('model.pt2').module()
    poses, scores, counts = program(images)

`--checkpoint` is the port's training checkpoint, `--torch-checkpoint` a
reference `.pth`; without either the weights are random and seeded (the
JAX package's `model.init`; here `init_he_` with BatchNorm calibrated on
noise at `--input-size`).
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict

import torch

THOP_GMACS_512 = 234.5     # the reference's thop count at 512^2


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--basenet', default='hourglass104',
                   choices=['hourglass104', 'hourglass52', 'hourglass4stage'])
    p.add_argument('--input-size', type=int, default=512)
    p.add_argument('--batch-size', type=int, default=1)
    p.add_argument('--output', default=None,
                   help='write the torch.export program (.pt2) to this path')
    p.add_argument('--checkpoint', default=None,
                   help="the port's training checkpoint to export")
    p.add_argument('--torch-checkpoint', default=None)
    p.add_argument('--to-torch', default=None, metavar='PATH',
                   help='write the weights as a reference-format .pth '
                        '(loadable by the reference framework, strict=True)')
    p.add_argument('--with-decode', action='store_true',
                   help='export forward + full decode instead of forward only')
    p.add_argument('--debug-tiny-model', action='store_true')
    p.add_argument('--hg-order', type=int, default=None,
                   help='hourglass recursion depth override (with --dims/'
                        '--modules/--cnv-dim: narrower real-depth variants)')
    p.add_argument('--dims', default=None,
                   help='comma-separated per-level channel dims')
    p.add_argument('--modules', default=None,
                   help='comma-separated per-level residual-module counts')
    p.add_argument('--cnv-dim', type=int, default=None)
    p.add_argument('--n-stacks', type=int, default=None)
    p.add_argument('--device', default=None,
                   help='torch device (default: the card)')
    return p.parse_args(argv)


def model_config(args):
    from ..config.defaults import ModelConfig
    if args.debug_tiny_model:
        return ModelConfig(basenet=args.basenet, n_stacks=1, hg_order=2,
                           dims=(8, 8, 12), modules=(1, 1, 1), cnv_dim=8,
                           compute_dtype='float32')
    kw = {}
    if args.hg_order is not None:
        kw['hg_order'] = args.hg_order
    if args.dims is not None:
        kw['dims'] = tuple(int(d) for d in args.dims.split(','))
    if args.modules is not None:
        kw['modules'] = tuple(int(m) for m in args.modules.split(','))
    if args.cnv_dim is not None:
        kw['cnv_dim'] = args.cnv_dim
    if args.n_stacks is not None:
        kw['n_stacks'] = args.n_stacks
    return ModelConfig(basenet=args.basenet, **kw)


def summarize(model: torch.nn.Module) -> Dict[str, int]:
    """Parameters per top module (`basenet`, `headnets`) and 'TOTAL'."""
    out = {name: sum(p.numel() for p in mod.parameters())
           for name, mod in model.named_children()}
    out['TOTAL'] = sum(out.values())
    return out


def count_flops(model: torch.nn.Module, images: torch.Tensor) -> int:
    """FLOPs of one forward on `images`, as FlopCounterMode counts them:
    convolutions and matmuls, two per multiply-add."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), counter:
        model(images)
    return counter.get_total_flops()


def reference_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's weights as the reference's state dict: float32 on the
    CPU, BatchNorm `num_batches_tracked` 0 (as the JAX package writes
    them). Hourglass-104 only: its module tree keeps the reference names."""
    if model.cfg.basenet != 'hourglass104':
        raise ValueError(
            f'torch export is defined for the reference Hourglass-104 module '
            f'tree only, not basenet={model.cfg.basenet!r}')
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith('num_batches_tracked'):
            sd[k] = torch.zeros((), dtype=torch.int64)
        else:
            sd[k] = v.detach().to('cpu', torch.float32).clone()
    return sd


def save_reference_checkpoint(path: str, model: torch.nn.Module, *,
                              epoch: int = 0,
                              train_loss: float = float('nan')) -> None:
    """A reference-format `.pth`: {epoch, train_loss, model_state_dict}."""
    torch.save({'epoch': epoch, 'train_loss': train_loss,
                'model_state_dict': reference_state_dict(model)}, path)


class Forward(torch.nn.Module):
    """The exported function: the model's forward, or with a
    postprocessor forward + `decode_body` -> (poses, scores, counts)."""

    def __init__(self, model: torch.nn.Module, postprocessor=None):
        super().__init__()
        self.model = model
        self.postprocessor = postprocessor

    def forward(self, images: torch.Tensor):
        preds = self.model(images)
        if self.postprocessor is None:
            return preds
        return self.postprocessor.decode_body(preds)


def export_program(model: torch.nn.Module, images: torch.Tensor,
                   postprocessor=None):
    """`torch.export.export` of `Forward` at the static shape of
    `images`. The model's parameters stop requiring gradients (the program
    is for inference), so its outputs do not require them either."""
    fwd = Forward(model, postprocessor).eval().requires_grad_(False)
    return torch.export.export(fwd, (images,))


def build_model(args, device):
    """The model of the width flags on `device` in eval mode, not yet
    folded: the checkpoint's weights, or `random_posenet(0)` calibrated at
    `--input-size`."""
    from ..models import PoseNet, random_posenet
    from .serve import load_weights
    cfg = model_config(args)
    state_dict = load_weights(args, cfg)
    if state_dict is not None:
        model = PoseNet(cfg)
        model.load_state_dict(state_dict, strict=True)
        return model.to(device).eval()
    return random_posenet(cfg, 0, device=device, calib_size=args.input_size)


def main(argv=None) -> Dict:
    """Runs the export; returns {'params' (summarize), 'flops',
    'export_s' (seconds of torch.export, None without --output),
    'program' (the ExportedProgram or None), 'model' (the model as
    exported: BatchNorm folded)}."""
    args = cli(argv)
    from ..config.defaults import DecoderConfig
    from ..decoder import PostProcessor
    from ..device import resolve_device

    dev = resolve_device(args.device)
    model = build_model(args, dev)
    params = summarize(model)
    for name, n in params.items():
        print(f'{name:>20}: {n / 1e6:10.3f} M params')
    if args.to_torch:
        save_reference_checkpoint(args.to_torch, model)
        print(f'wrote reference-format torch checkpoint: {args.to_torch}')

    model.prepare_inference()
    s = args.input_size
    x = torch.zeros((args.batch_size, s, s, 3), dtype=torch.float32,
                    device=dev)
    flops = count_flops(model, x)
    print(f'FlopCounterMode: {flops / 1e9:.2f} GFLOPs ({flops / 2e9:.2f} '
          f'GMACs) @ {args.batch_size}x{s}x{s} (reference thop count, which '
          f'tallies MACs: {THOP_GMACS_512} G @512^2)')

    out = {'params': params, 'flops': flops, 'export_s': None,
           'program': None, 'model': model}
    if args.output:
        pp = PostProcessor(cfg=DecoderConfig()) if args.with_decode else None
        t0 = time.perf_counter()
        program = export_program(model, x, pp)
        out['export_s'] = time.perf_counter() - t0
        torch.export.save(program, args.output)
        size = os.path.getsize(args.output)
        print(f'wrote torch.export program: {args.output} '
              f'({size / 1e6:.1f} MB, export {out["export_s"]:.1f} s)')
        out['program'] = program
    return out


if __name__ == '__main__':
    main()
