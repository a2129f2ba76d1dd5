#!/usr/bin/env python
"""COCO keypoint evaluation: preprocess, forward, decode, inverse
transform, OKS AP.

Port of the JAX package's `cli/evaluate.py`, on `--device` (the card
unless told otherwise). Weights: `--checkpoint` (a `posenet_NNN.pt` of the
port's trainer, without its optimizer state), `--torch-checkpoint` (a
reference `.pth`, loaded leaf by leaf as the JAX package converts it; the
unmatched entries are printed and keep the trainer's fresh init), or
random seeded weights with BatchNorm calibrated at `--long-edge`
(`--debug-tiny-model` for a narrow network). Images are read with
`data/coco.py::read_image`: JPEG and PNG through the port's codec
(`data/codec.py`), `.npy` uint8 RGB with numpy.

`--basenet hourglass4stage` evaluates a 4-stage checkpoint of the port's
trainer (`--n-stacks`: its depth, by default the published 4).
`--dataset crowdpose` evaluates the CrowdPose 14-keypoint configuration:
the heads follow the skeleton, and the metric is the CrowdPose protocol
(AP and the easy / medium / hard crowdIndex bands). Not taken here:
`--peaks-map-batch` (a TPU tuning knob with the same results).

    python -m offsetguided_tpu_torch.cli.evaluate --image-dir images \\
        --annotation-file ann.json --fixed-height --flip-test
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import torch


def cli(argv=None):
    from .serve import add_network_flags
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--image-dir', required=True)
    p.add_argument('--annotation-file', required=True)
    w = p.add_mutually_exclusive_group()
    w.add_argument('--checkpoint', default=None,
                   help="the port's training checkpoint (posenet_NNN.pt)")
    w.add_argument('--torch-checkpoint', default=None,
                   help='reference .pth checkpoint to convert and evaluate')
    p.add_argument('--device', default=None,
                   help="torch device; default the CUDA card, 'cpu' runs the "
                        'plain PyTorch versions of the kernels')
    p.add_argument('--long-edge', type=int, default=640)
    p.add_argument('--fixed-height', action='store_true')
    p.add_argument('--flip-test', action='store_true')
    p.add_argument('--batch-size', type=int, default=8)
    p.add_argument('--n-images', type=int, default=None)
    p.add_argument('--topk', type=int, default=32)
    p.add_argument('--thre-hmp', type=float, default=0.04)
    p.add_argument('--dist-max', type=float, default=40.0)
    p.add_argument('--person-thre', type=float, default=0.06)
    p.add_argument('--lowres-decode', action='store_true',
                   help='decode at stride resolution (fast path)')
    p.add_argument('--feat-stage', type=int, default=-1,
                   help="which stack's predictions to decode")
    p.add_argument('--min-len', type=float, default=0.5)
    p.add_argument('--sort-dim', type=int, default=2, choices=[2, 4],
                   help='pose ranking: 2=keypoint score, 4=limb score')
    p.add_argument('--resize-mode', default='bicubic',
                   choices=['bicubic', 'bilinear'])
    p.add_argument('--no-jitter-refine', action='store_true',
                   help='disable jitter-offset coordinate refinement')
    p.add_argument('--no-scale', action='store_true',
                   help='ignore inferred keypoint scales in the dist gate')
    p.add_argument('--max-stride', type=int, default=128)
    p.add_argument('--width-bucket', type=int, default=256,
                   help='fixed-height mode: width padding bucket')
    p.add_argument('--scored-offset', action='store_true',
                   help='heatmap-weighted offset refinement before limb '
                        'collection')
    p.add_argument('--cat-flip-offset', action='store_true',
                   help='flip-test: keep both offset vectors and pair by '
                        '4-D distance instead of averaging')
    p.add_argument('--guid-jitter-refine', action='store_true',
                   help='refine regressed guiding endpoints with the jitter '
                        'offset before pairing')
    p.add_argument('--io-workers', type=int, default=4,
                   help='host IO/preprocess threads feeding the device loop')
    p.add_argument('--dataset', default='coco', choices=['coco', 'crowdpose'])
    p.add_argument('--all-images', action='store_true',
                   help='include images without annotations (test-dev)')
    p.add_argument('--results-json', default=None)
    p.add_argument('--debug-tiny-model', action='store_true',
                   help='narrow random-weight network: exercises the whole '
                        'pipeline quickly')
    p.add_argument('--hg-order', type=int, default=None,
                   help='hourglass recursion depth override (with --dims/'
                        '--modules/--cnv-dim: narrower variants)')
    p.add_argument('--dims', default=None,
                   help='comma-separated per-level channel dims')
    p.add_argument('--modules', default=None,
                   help='comma-separated per-level residual-module counts')
    p.add_argument('--cnv-dim', type=int, default=None)
    add_network_flags(p)
    args = p.parse_args(argv)
    bucket = max(args.width_bucket, args.max_stride)
    if bucket % args.max_stride != 0:
        p.error(f'--width-bucket ({args.width_bucket}) must be a multiple of '
                f'--max-stride ({args.max_stride})')
    return args


def model_config(args):
    """Hourglass-104 (or `--debug-tiny-model`'s narrow fp32 network, or
    the `--basenet` / `--n-stacks` network) with the heads of
    `--dataset`'s skeleton; the width flags shape Hourglass-104 alone."""
    from ..config.defaults import HeadsConfig, ModelConfig, SkeletonConfig
    from .serve import network_kwargs
    skeleton = SkeletonConfig.for_dataset(args.dataset)
    heads = HeadsConfig(n_keypoints=skeleton.n_keypoints,
                        n_limbs=skeleton.n_limbs)
    net = network_kwargs(args)
    if args.debug_tiny_model:
        return ModelConfig(n_stacks=1, hg_order=2, dims=(8, 8, 12),
                           modules=(1, 1, 1), cnv_dim=8,
                           compute_dtype='float32', heads=heads)
    kw = {}
    if args.hg_order is not None:
        kw['hg_order'] = args.hg_order
    if args.dims is not None:
        kw['dims'] = tuple(int(d) for d in args.dims.split(','))
    if args.modules is not None:
        kw['modules'] = tuple(int(m) for m in args.modules.split(','))
    if args.cnv_dim is not None:
        kw['cnv_dim'] = args.cnv_dim
    return ModelConfig(heads=heads, **net, **kw)


def main(argv=None) -> Dict[str, float]:
    """Runs the evaluation; prints and returns the COCO keypoint metrics
    (with `--dataset crowdpose`: AP and the three crowdIndex band APs) and
    `img_per_s`, the images evaluated per second of `run_images`."""
    args = cli(argv)
    from ..config.defaults import DecoderConfig, EvalConfig, SkeletonConfig
    from ..data.coco import CocoJson
    from ..decoder import PostProcessor
    from ..device import resolve_device
    from ..eval.cocoeval import (evaluate_coco_keypoints,
                                 evaluate_crowdpose_keypoints)
    from ..eval.harness import eval_image_ids, run_images
    from ..models import PoseNet, random_posenet
    from .serve import load_weights

    dev = resolve_device(args.device)
    skeleton = SkeletonConfig.for_dataset(args.dataset)
    model_cfg = model_config(args)
    state_dict = load_weights(args, model_cfg)
    if state_dict is not None:
        model = PoseNet(model_cfg)
        model.load_state_dict(state_dict, strict=True)
    else:
        model = random_posenet(model_cfg, 0, device=dev,
                               calib_size=args.long_edge)
    model = model.to(dev).prepare_inference()

    pp = PostProcessor(skeleton=skeleton, cfg=DecoderConfig(
        topk=args.topk, thre_hmp=args.thre_hmp, dist_max=args.dist_max,
        person_thre=args.person_thre, min_len=args.min_len,
        sort_dim=args.sort_dim, resize_mode=args.resize_mode,
        feat_stage=args.feat_stage,
        use_jitter_offset=not args.no_jitter_refine,
        use_scale=not args.no_scale,
        upsampled_decode=not args.lowres_decode,
        scored_offset=args.scored_offset,
        cat_flip_offs=args.cat_flip_offset,
        guid_jitter_refine=args.guid_jitter_refine))
    eval_cfg = EvalConfig(long_edge=args.long_edge,
                          fixed_height=args.fixed_height,
                          max_stride=args.max_stride,
                          width_bucket=args.width_bucket,
                          flip_test=args.flip_test,
                          batch_size=args.batch_size,
                          io_workers=args.io_workers)

    coco = CocoJson(args.annotation_file)
    ids = eval_image_ids(coco, n_images=args.n_images,
                         all_images=args.all_images)
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    results = run_images(model, pp, coco, args.image_dir, eval_cfg,
                         n_images=args.n_images, skeleton=skeleton,
                         progress=True, all_images=args.all_images)
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    if args.results_json:
        with open(args.results_json, 'w') as f:
            json.dump(results, f)
    # the metric covers the evaluated image set only
    evaluate_keypoints = (evaluate_crowdpose_keypoints
                          if args.dataset == 'crowdpose'
                          else evaluate_coco_keypoints)
    stats = evaluate_keypoints(coco, results, skeleton.sigmas, image_ids=ids)
    for k, v in stats.items():
        print(f'{k}: {v:.4f}')
    print(f'{len(ids)} images in {seconds:.3f} s: {len(ids) / seconds:.2f} '
          f'img/s on {dev} (host clock, IO and preprocess included)')
    return dict(stats, img_per_s=len(ids) / seconds)


if __name__ == '__main__':
    main()
