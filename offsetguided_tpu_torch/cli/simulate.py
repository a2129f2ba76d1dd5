#!/usr/bin/env python
"""Oracle simulation: ground-truth encoder output fed straight into the
decoder, then COCO OKS evaluation: the AP ceiling of the encode/decode
scheme, without any network.

Port of the JAX package's `cli/simulate.py`. The encoder and the decoder
run on `--device` (the card unless told otherwise), so the decode goes
through the port's CUDA kernels there and through their plain versions on
the CPU. Images are never read (the encoder needs only the annotations),
so the JAX version's `--image-dir` is not taken.

    python -m offsetguided_tpu_torch.cli.simulate --annotation-file ann.json
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--annotation-file', required=True)
    p.add_argument('--long-edge', type=int, default=640)
    p.add_argument('--n-images', type=int, default=None)
    p.add_argument('--topk', type=int, default=32)
    p.add_argument('--thre-hmp', type=float, default=0.1)
    p.add_argument('--dist-max', type=float, default=40.0)
    p.add_argument('--max-persons', type=int, default=48)
    p.add_argument('--capacity', type=int, default=None,
                   help='grouping skeleton-row capacity '
                        '(DecoderConfig.capacity)')
    p.add_argument('--max-poses', type=int, default=None,
                   help='grouped-output pose capacity (DecoderConfig.max_poses)')
    p.add_argument('--lowres-decode', action='store_true',
                   help='decode at stride resolution')
    p.add_argument('--device', default=None,
                   help="torch device; default the CUDA card, 'cpu' runs the "
                        'plain PyTorch versions of the kernels')
    p.add_argument('--flip-test', action='store_true',
                   help='encode the W-mirrored annotations as the second '
                        'half-batch and decode through the flip merge')
    p.add_argument('--scored-offset', action='store_true',
                   help='heatmap-weighted offset refinement before limb '
                        'collection')
    p.add_argument('--cat-flip-offset', action='store_true',
                   help='flip-test: keep both offset vectors and pair by '
                        '4-D distance instead of averaging')
    p.add_argument('--guid-jitter-refine', action='store_true',
                   help='refine regressed guiding endpoints with the jitter '
                        'offset before pairing')
    return p.parse_args(argv)


def main(argv=None) -> Dict[str, float]:
    """Runs the oracle; prints and returns the COCO keypoint metrics."""
    args = cli(argv)
    from ..config.defaults import DecoderConfig, EncoderConfig, SkeletonConfig
    from ..data import transforms as T
    from ..data.coco import CocoJson
    from ..decoder import PostProcessor
    from ..device import resolve_device
    from ..eval.cocoeval import evaluate_coco_keypoints
    from ..eval.harness import poses_to_coco_results
    from ..ops.encoder import encode_targets

    dev = resolve_device(args.device)
    skeleton = SkeletonConfig()
    enc_cfg = EncoderConfig(max_persons=args.max_persons)
    cap_kw = {}
    if args.capacity is not None:
        cap_kw['capacity'] = args.capacity
    if args.max_poses is not None:
        cap_kw['max_poses'] = args.max_poses
    pp = PostProcessor(skeleton=skeleton, cfg=DecoderConfig(
        topk=args.topk, thre_hmp=args.thre_hmp, dist_max=args.dist_max,
        use_scale=False, person_thre=0.1,
        upsampled_decode=not args.lowres_decode,
        scored_offset=args.scored_offset,
        cat_flip_offs=args.cat_flip_offset,
        guid_jitter_refine=args.guid_jitter_refine, **cap_kw))
    coco = CocoJson(args.annotation_file)
    size = args.long_edge
    kp_flip = np.asarray(skeleton.heatmap_flip_indices())

    def encode(padded):
        t = encode_targets(torch.from_numpy(padded).to(dev), skeleton.sigmas,
                           skeleton.skeleton, size // enc_cfg.stride,
                           size // enc_cfg.stride, enc_cfg)
        return {'hmp': t.hmp, 'jomp': t.jomp, 'omp': t.omp}

    def mirror_annotations(padded):
        """The W-mirrored image's GT: x -> size-1-x, L/R labels swap."""
        flipped = padded[:, :, kp_flip, :].copy()
        valid = flipped[..., 2] > 0
        flipped[..., 0] = np.where(valid, size - 1 - flipped[..., 0], 0.0)
        return flipped

    results = []
    ids = coco.image_ids(with_persons=True, with_keypoints=True)
    if args.n_images:
        ids = ids[:args.n_images]
    for idx, img_id in enumerate(ids):
        info = coco.image_info(img_id)
        anns = T.normalize_annotations(coco.anns_for_image(img_id),
                                       skeleton.sigmas, skeleton.n_keypoints)
        meta = T.make_meta(info['width'], info['height'],
                           skeleton.n_keypoints)
        dummy = np.zeros((info['height'], info['width'], 3), np.uint8)
        img2, anns, meta = T.rescale_long_absolute(dummy, anns, meta, size)
        _, anns, meta = T.center_pad(img2, anns, meta, size)
        padded = np.zeros((1, enc_cfg.max_persons, skeleton.n_keypoints, 4),
                          np.float32)
        padded[0, :min(len(anns), enc_cfg.max_persons)] = \
            anns[:enc_cfg.max_persons]
        with torch.inference_mode():
            maps = encode(padded)
            if args.flip_test:
                mirrored = encode(mirror_annotations(padded))
                maps = {k: torch.cat([v, mirrored[k]]) for k, v in maps.items()}
            preds = {k: [v] for k, v in maps.items()}
            preds['scmp'] = [None]
            poses, _, counts = pp.decode_body(preds, flip_test=args.flip_test)
        valid = poses[0, :int(counts[0])].cpu().numpy()
        results.extend(poses_to_coco_results(
            T.annotations_inverse(valid, meta), img_id))
        if idx % 100 == 0:
            print(f'simulate {idx}/{len(ids)}')

    stats = evaluate_coco_keypoints(coco, results, skeleton.sigmas,
                                    image_ids=ids)
    print('--- oracle (GT -> decoder) COCO metrics ---')
    for k, v in stats.items():
        print(f'{k}: {v:.4f}')
    return stats


if __name__ == '__main__':
    main()
