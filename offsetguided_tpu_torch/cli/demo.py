#!/usr/bin/env python
"""Image demo: pose estimation on image files, painted into PNGs.

Port of the JAX package's `cli/demo.py` with its flags, plus `--device`
(the card unless told otherwise). Each image is read through the port's
codec (JPEG / PNG), rescaled and padded (`preprocess_eval`), run through
the network and `PostProcessor.decode_body` (on the card the fused peaks
and grouping kernels), mapped back to image coordinates and painted
(`visualization/show.py`, no matplotlib) into `<name>.poses.png`; with
`--show-heatmaps` / `--show-hmp-idx` the heatmap overlay
`<name>.hmp.png`, with `--show-limb-offsets L` limb L's guiding offsets
`<name>.omp.png`, with `--show-all-limbs` every candidate limb above
`--limb-thre` `<name>.limbs.png` (collected at full resolution through the
block top-k kernel). `--annotation-file` also prints the per-head losses
against the image's ground truth.

Weights: `--torch-checkpoint` a reference `.pth`, `--checkpoint` the
port's own training checkpoint, otherwise random seeded weights with
BatchNorm calibrated at `--long-edge` (as `cli/serve.py` makes them).

    python -m offsetguided_tpu_torch.cli.demo image.jpg [--flip-test]
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np
import torch


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('images', nargs='+', help='image paths')
    p.add_argument('--checkpoint', default=None,
                   help="the port's training checkpoint (posenet_NNN.pt)")
    p.add_argument('--torch-checkpoint', default=None,
                   help='reference .pth checkpoint')
    p.add_argument('--long-edge', type=int, default=640)
    p.add_argument('--flip-test', action='store_true')
    p.add_argument('--output-dir', default='demo_out')
    p.add_argument('--show-heatmaps', action='store_true')
    p.add_argument('--show-hmp-idx', type=int, default=None,
                   help='overlay one heatmap channel instead of the '
                        'channel max')
    p.add_argument('--show-limb-offsets', type=int, default=None,
                   help='limb index whose guiding offsets to draw')
    p.add_argument('--show-all-limbs', action='store_true',
                   help='draw every candidate limb above --limb-thre')
    p.add_argument('--limb-thre', type=float, default=0.1)
    p.add_argument('--annotation-file', default=None,
                   help='COCO annotations: also print the per-head losses '
                        'against the ground truth')
    p.add_argument('--scored-offset', action='store_true',
                   help='heatmap-weighted offset refinement before limb '
                        'collection')
    p.add_argument('--device', default=None,
                   help='torch device (default: the card)')
    return p.parse_args(argv)


def build(args, device=None, seed: int = 0):
    """-> (model, postprocessor, eval_cfg, skeleton) on the device: the
    weights of `--torch-checkpoint` or `--checkpoint`, else
    `random_posenet(seed)` calibrated at `--long-edge`; BatchNorm folded,
    the backbone in its compute dtype."""
    from ..config.defaults import (DecoderConfig, EvalConfig, ModelConfig,
                                   SkeletonConfig)
    from ..decoder import PostProcessor
    from ..device import resolve_device
    from ..models import PoseNet, random_posenet
    from .serve import load_weights

    dev = resolve_device(device)
    skeleton = SkeletonConfig()
    model_cfg = ModelConfig()
    state_dict = load_weights(args, model_cfg)
    if state_dict is not None:
        model = PoseNet(model_cfg)
        model.load_state_dict(state_dict, strict=True)
    else:
        model = random_posenet(model_cfg, seed, device=dev,
                               calib_size=args.long_edge)
    model = model.to(dev).prepare_inference()
    pp = PostProcessor(skeleton=skeleton,
                       cfg=DecoderConfig(scored_offset=args.scored_offset))
    eval_cfg = EvalConfig(long_edge=args.long_edge, flip_test=args.flip_test,
                          batch_size=1)
    return model, pp, eval_cfg, skeleton


def image_losses(preds, anns_s: np.ndarray, img_hw, skeleton
                 ) -> Dict[str, float]:
    """The per-head losses of the first image's last-stack predictions
    against its ground truth `anns_s` (network-input pixels): the JAX
    demo's encoder (32 persons) and losses (one stack, weight 1)."""
    from ..config.defaults import EncoderConfig, LossConfig
    from ..ops.encoder import encode_targets
    from ..ops.losses import compute_losses

    enc = EncoderConfig(max_persons=32)
    J = skeleton.n_keypoints
    padded = np.zeros((1, enc.max_persons, J, 4), np.float32)
    padded[0, :min(len(anns_s), enc.max_persons)] = anns_s[:enc.max_persons]
    hw = img_hw[0] // enc.stride, img_hw[1] // enc.stride
    dev = preds['hmp'][-1].device
    t = encode_targets(torch.from_numpy(padded).to(dev),
                       np.asarray(skeleton.sigmas), skeleton.skeleton,
                       hw[0], hw[1], enc)
    mask = torch.ones((1, hw[0], hw[1], 1), dtype=torch.bool, device=dev)
    single = {k: [v[-1][:1] if v[-1] is not None else None]
              for k, v in preds.items()}
    losses = compute_losses(single, t, mask, LossConfig(stack_weights=(1.0,)))
    return {k: float(v) for k, v in losses.items()}


def run_image(path: str, model, pp, eval_cfg, skeleton, args,
              gt_anns: Optional[np.ndarray] = None) -> Dict:
    """One image through preprocess, forward + decode and the painter.
    Returns {'poses' (n, J, 6) in image coordinates, 'scores' (n,),
    'losses' (with `gt_anns`, else None), 'files' (the PNGs written)}."""
    from ..data import transforms as T
    from ..data.coco import read_image
    from ..eval.harness import preprocess_eval
    from ..ops import decoder as dec_ops
    from ..ops.image import normalize_images
    from ..ops.resize import upsample2d
    from ..data import draw
    from ..visualization import (KeypointPainter, draw_limb_offset,
                                 heatmap_overlay, image_canvas)
    from ..visualization.show import COLORS

    raw = read_image(path)
    if raw is None:
        raise FileNotFoundError(path)
    J = skeleton.n_keypoints
    if gt_anns is None:
        gt_anns = np.zeros((0, J, 4), np.float32)
    img, anns_s, meta = preprocess_eval(raw, gt_anns, eval_cfg, J)
    dev = next(model.parameters()).device
    with torch.inference_mode():
        x = normalize_images(torch.from_numpy(img[None]).to(dev))
        if args.flip_test:
            x = torch.cat([x, torch.flip(x, dims=(2,))])
        preds = model(x)
        poses, scores, counts = pp.decode_body(preds,
                                               flip_test=args.flip_test)
        n = int(counts[0])
        valid_rows = poses[0, :n].cpu().numpy()
        inv = T.annotations_inverse(valid_rows, meta)
        losses = (image_losses(preds, anns_s, img.shape[:2], skeleton)
                  if len(anns_s) else None)
    if losses is not None:
        print('  losses:', {k: round(v, 5) for k, v in losses.items()})

    base = os.path.join(args.output_dir,
                        os.path.splitext(os.path.basename(path))[0])
    files = [base + '.poses.png']
    with image_canvas(raw, files[-1]) as ax:
        KeypointPainter(skeleton_cfg=skeleton).keypoints(
            ax, inv, scores=scores[0].cpu().numpy())
    print(f'{path}: {n} poses -> {files[-1]}')
    light = img / 255.0 * 0.5 + 0.5
    if args.show_heatmaps or args.show_hmp_idx is not None:
        files.append(base + '.hmp.png')
        with image_canvas(light, files[-1]) as ax:
            heatmap_overlay(ax, img / 255.0 * 0.2 + 0.5,
                            preds['hmp'][-1][0].cpu().numpy(),
                            channel=args.show_hmp_idx)
    if args.show_limb_offsets is not None:
        files.append(base + '.omp.png')
        with image_canvas(light, files[-1]) as ax:
            draw_limb_offset(ax, preds['omp'][-1][0].cpu().numpy(),
                             args.show_limb_offsets)
    if args.show_all_limbs:
        maps = pp.select_stage(preds)
        with torch.inference_mode():
            hmp_up = upsample2d(maps['hmp'][:1], pp.cfg.stride,
                                pp.cfg.resize_mode)
            limbs = dec_ops.collect_limbs_peak_sampled(
                hmp_up, maps['omp'][:1], pp._jf, pp._jt, pp.cfg,
                jomps4=(maps['jomp'][:1] if maps['jomp'] is not None
                        else None),
                scmps4=(maps['scmp'][:1] if maps['scmp'] is not None
                        else None), stride=pp.cfg.stride)
            packed = dec_ops.pack_limbs(limbs)[0].cpu().numpy()  # (L, K, 13)
        files.append(base + '.limbs.png')
        with image_canvas(light, files[-1]) as ax:
            rows = packed.reshape(-1, 13)
            keep = ((rows[:, 10] >= args.limb_thre) & (rows[:, 0] >= 0)
                    & (rows[:, 3] >= 0))
            for r in rows[keep]:
                draw.segments(ax.pixels, r[0:2], r[3:5], COLORS['lime'],
                              alpha=min(1.0, 0.2 + float(r[10])))
    return {'poses': inv, 'scores': scores[0, :n].cpu().numpy(),
            'losses': losses, 'files': files}


def main(argv=None):
    """Runs the demo; returns one `run_image` result per image."""
    args = cli(argv)
    from ..config.defaults import SkeletonConfig
    from ..data import transforms as T
    from ..data.coco import CocoJson

    model, pp, eval_cfg, skeleton = build(args, args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    coco, name_to_id = None, {}
    if args.annotation_file:
        coco = CocoJson(args.annotation_file)
        name_to_id = {coco.image_info(i)['file_name']: i
                      for i in coco.image_ids()}
    results = []
    for path in args.images:
        gt = None
        img_id = name_to_id.get(os.path.basename(path))
        if img_id is not None:
            gt = T.normalize_annotations(coco.anns_for_image(img_id),
                                         SkeletonConfig().sigmas)
        results.append(run_image(path, model, pp, eval_cfg, skeleton, args,
                                 gt))
    return results


if __name__ == '__main__':
    main()
