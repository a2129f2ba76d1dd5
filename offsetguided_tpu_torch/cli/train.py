#!/usr/bin/env python
"""Training on one device, or data parallel over processes
(`--distributed`).

Port of the JAX package's `cli/train.py` with its flag names and defaults,
on `--device` (the card unless told otherwise). Each step: the loader (one
background thread, or `--loader-workers` processes writing into shared
memory) reads images, renders miss masks and, by default, augments on the
host: annotation jitter, the affine warp of image and mask, gray and tint,
with the values of the JAX package's cv2 calls (`data/pixels.py`, the
warp in C++ through ctypes). With `--device-aug` the host only samples
the parameters, and the warp, photometric pass and annotation transform
run on the device (`ops/augment.py`). The batch goes to the device
(pinned, non-blocking); GT encoding and mask downscaling
(`ops/encoder.py`) make the targets there; then the train step
(`parallel/train_step.py`): forward in train mode (bf16 autocast
backbone, fp32 parameters and BatchNorm statistics), losses, backward,
the explosion guard, Adam. With `--val-image-dir` / `--val-annotations`,
each epoch end runs the validation losses over the unaugmented samples.
Checkpoints at epoch ends (`--save-every`) and at `--max-steps`.

`--dataset crowdpose` trains the CrowdPose 14-keypoint configuration (the
skeleton sets the heads, the encoder's targets and the flip pairs);
`--basenet hourglass4stage` the 4-stage backbone (fixed widths: `--n-stacks`
and `--remat` apply, the Hourglass-104 width flags do not, and
`--debug-tiny-model` narrows only Hourglass-104, as in the JAX package).
The device-aug warp is `--warp-impl tiled` (windowed banded matmuls, the
default, as in the JAX package) or `patch` (the 4x4-footprint gather).

Fine-tuning, with the JAX trainer's flags and selections (each a
`re.search` over the JAX parameter paths, as `PoseHeads_0/omp_0/kernel`,
that `models/checkpoint.py::key_map` gives every port parameter):
`--torch-checkpoint` warm-starts from a reference `.pth` (a full network,
or the bare pretrained backbone), leaf by leaf as the JAX package converts
it; `--freeze REGEX` zeroes the matching parameters' gradients before the
clip and the optimizer (weight decay still moves them, as JAX's
`masked(set_to_zero)` chain does); `--resume` restores leaf by leaf, with
`--drop-layers REGEX` leaving the matching leaves at their fresh values
and `--drop-optim-state` the optimizer state fresh at step 0.

`--distributed` trains data parallel, one process per device
(`parallel/distributed.py`), as the JAX trainer's processes do: each
iterates the same seeded global batch stream and keeps its contiguous
slice (`--batch-size` is the global batch and must divide by the number
of processes); BatchNorm statistics, loss normalizers and gradients are
the global batch's, so the step is the one-process step on the whole
batch. Rank 0 logs and writes the checkpoints (the others wait for each
write at a barrier); `--resume` loads on every rank. The group meets at
`--coordinator-address host:port` with `--num-processes` and
`--process-id`, or, without an address, through torchrun's environment
(`torchrun --nproc-per-node N -m offsetguided_tpu_torch.cli.train
--distributed ...`). NCCL on the cards; gloo on the CPU and with
`--share-device` (ranks sharing one card).

    python -m offsetguided_tpu_torch.cli.train \\
        --train-image-dir images --train-annotations ann.json
"""
from __future__ import annotations

import argparse
import logging
import time
from typing import Dict

import numpy as np


def cli(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    g = p.add_argument_group('data')
    g.add_argument('--train-image-dir', required=True)
    g.add_argument('--train-annotations', required=True)
    g.add_argument('--val-image-dir', default=None)
    g.add_argument('--val-annotations', default=None)
    g.add_argument('--square-length', type=int, default=512)
    g.add_argument('--max-persons', type=int, default=32)
    g.add_argument('--n-images', type=int, default=None)
    g.add_argument('--warp-impl', default='tiled',
                   choices=['patch', 'tiled'],
                   help='device-aug bicubic warp: tiled = windowed banded '
                        'matmuls (default; ops/augment.py::'
                        'affine_sample_tiled); patch = 4x4 footprint gather')
    g.add_argument('--device-aug', action='store_true',
                   help='warp + photometric augmentation on the device '
                        '(ops/augment.py); the host keeps image read, mask '
                        'render and parameter sampling. Default: augment '
                        'on the host')
    g.add_argument('--raw-canvas', type=int, default=640,
                   help='device-aug: fixed raw-image canvas side (largest '
                        'source image side; COCO is 640)')

    g = p.add_argument_group('augmentation')
    g.add_argument('--flip-prob', type=float, default=0.5)
    g.add_argument('--max-rotate', type=float, default=45.0)
    g.add_argument('--min-scale', type=float, default=0.5)
    g.add_argument('--max-scale', type=float, default=2.0)
    g.add_argument('--min-stretch', type=float, default=0.95)
    g.add_argument('--max-stretch', type=float, default=1.05)
    g.add_argument('--max-translate', type=int, default=150)

    g = p.add_argument_group('encoder')
    g.add_argument('--sigma', type=float, default=7.0)
    g.add_argument('--gaussian-clip', type=float, default=0.01)
    g.add_argument('--fill-jitter-size', type=int, default=3)
    g.add_argument('--fill-scale-size', type=int, default=7)

    g = p.add_argument_group('model')
    g.add_argument('--basenet', default='hourglass104',
                   choices=['hourglass104', 'hourglass52', 'hourglass4stage'])
    g.add_argument('--n-stacks', type=int, default=2)
    g.add_argument('--no-background', action='store_true')
    g.add_argument('--no-jitter-offset', action='store_true')
    g.add_argument('--no-scale', action='store_true')
    g.add_argument('--n-limbs', type=int, default=19,
                   choices=[16, 19, 25, 31, 44])
    g.add_argument('--dataset', default='coco', choices=['coco', 'crowdpose'])
    g.add_argument('--hg-order', type=int, default=None)
    g.add_argument('--dims', default=None,
                   help='comma-separated per-level channel dims '
                        '(len = hg_order + 1)')
    g.add_argument('--modules', default=None,
                   help='comma-separated per-level residual-module counts')
    g.add_argument('--cnv-dim', type=int, default=None)
    g.add_argument('--remat', action='store_true',
                   help='recompute each hourglass stack in the backward '
                        '(torch.utils.checkpoint): ~n_stacks x less '
                        'activation memory for ~1 extra forward per stack')

    g = p.add_argument_group('optimization')
    g.add_argument('--optimizer', default='adam', choices=['adam', 'sgd'])
    g.add_argument('--opt-state-dtype', default='float32',
                   choices=['float32', 'bfloat16'])
    g.add_argument('--lr', type=float, default=1.25e-4)
    g.add_argument('--momentum', type=float, default=0.9)
    g.add_argument('--weight-decay', type=float, default=0.0)
    g.add_argument('--max-grad-norm', type=float, default=None)
    g.add_argument('--epochs', type=int, default=120)
    g.add_argument('--batch-size', type=int, default=16)
    g.add_argument('--warmup-epochs', type=int, default=0)
    g.add_argument('--freeze', default=None)

    g = p.add_argument_group('losses')
    g.add_argument('--hmp-loss', default='focal_l2', choices=['l2', 'focal_l2'])
    g.add_argument('--offset-loss', default='offset_instance_l1',
                   choices=['offset_l1', 'offset_instance_l1',
                            'offset_laplace'])
    g.add_argument('--jitter-offset-loss', default='offset_l1',
                   choices=['offset_l1', 'offset_instance_l1',
                            'offset_laplace'])
    g.add_argument('--scale-loss', default='scale_l1', choices=['scale_l1'])
    g.add_argument('--sqrt-re', dest='sqrt_re', action='store_true',
                   default=True)
    g.add_argument('--no-sqrt-re', dest='sqrt_re', action='store_false')
    g.add_argument('--ftao', type=float, default=0.01)
    g.add_argument('--fgamma', type=float, default=2.0)
    g.add_argument('--lmargin', type=float, default=1e-5)
    g.add_argument('--scale-margin', type=float, default=0.1)
    g.add_argument('--lambdas', type=float, nargs=5,
                   default=[1.0, 0.0, 0.0, 10000.0, 10.0])
    g.add_argument('--stack-weights', type=float, nargs='+', default=None)

    g = p.add_argument_group('runtime')
    g.add_argument('--device', default=None,
                   help="torch device; default the CUDA card")
    g.add_argument('--checkpoint-dir', default='checkpoints')
    g.add_argument('--resume', default=None,
                   help="a checkpoint of this package's trainer")
    g.add_argument('--torch-checkpoint', default=None,
                   help='warm start from a reference .pth (full network or '
                        'backbone only; unmatched entries keep their fresh '
                        'initialization)')
    g.add_argument('--drop-optim-state', action='store_true')
    g.add_argument('--recount-epoch', action='store_true')
    g.add_argument('--drop-layers', default=None)
    g.add_argument('--print-freq', type=int, default=20)
    g.add_argument('--log-file', default=None)
    g.add_argument('--save-every', type=int, default=1)
    g.add_argument('--distributed', action='store_true')
    g.add_argument('--coordinator-address', default=None)
    g.add_argument('--num-processes', type=int, default=None)
    g.add_argument('--process-id', type=int, default=None)
    g.add_argument('--share-device', action='store_true',
                   help='--distributed ranks share one card: gloo instead '
                        'of NCCL (which needs a card per rank)')
    g.add_argument('--seed', type=int, default=0)
    g.add_argument('--loader-workers', type=int, default=0,
                   help='loader processes (0 = one background thread)')
    g.add_argument('--debug-tiny-model', action='store_true',
                   help='swap in a narrow backbone (CI smoke tests)')
    g.add_argument('--max-steps', type=int, default=None,
                   help='stop after this many optimizer steps')
    return p.parse_args(argv)


def model_config(args, heads):
    from ..config.defaults import ModelConfig
    if args.debug_tiny_model:
        return ModelConfig(basenet=args.basenet, n_stacks=args.n_stacks,
                           hg_order=2, dims=(16, 16, 24), modules=(1, 1, 1),
                           cnv_dim=16, compute_dtype='float32', heads=heads,
                           remat=args.remat)
    kw = {}
    if args.hg_order is not None:
        kw['hg_order'] = args.hg_order
    if args.dims is not None:
        kw['dims'] = tuple(int(d) for d in args.dims.split(','))
    if args.modules is not None:
        kw['modules'] = tuple(int(m) for m in args.modules.split(','))
    if args.cnv_dim is not None:
        kw['cnv_dim'] = args.cnv_dim
    return ModelConfig(basenet=args.basenet, n_stacks=args.n_stacks,
                       heads=heads, remat=args.remat, **kw)


def device_batch(batch, dataset, dev, enc_cfg, skeleton,
                 square_length: int, warp_impl: str = 'tiled',
                 slope_bound: float = 3.0):
    """Host batch -> (uint8 images, targets, bool mask) on `dev`, inputs
    pinned and copied without blocking on a CUDA device. A device-aug
    batch (it carries `aug_mat`) is warped there first (`warp_impl`,
    `slope_bound`: `augment_batch_dict`'s); a host-route batch
    arrives warped, its mask uint8 in [0, 255]. GT encoding and the mask
    downscale run on the device on both routes."""
    import torch
    from ..ops.augment import augment_batch_dict
    from ..ops.encoder import downscale_mask, encode_targets
    keys = (dataset.sample_spec() if 'aug_mat' in batch
            else ('image', 'anns', 'mask_miss'))
    dev_b = {}
    for k in keys:
        t = torch.from_numpy(batch[k])
        dev_b[k] = (t.pin_memory().to(dev, non_blocking=True)
                    if dev.type == 'cuda' else t)
    out_hw = square_length // enc_cfg.stride
    with torch.no_grad():
        if 'aug_mat' in dev_b:
            imgs, mask, anns = augment_batch_dict(
                dev_b, square_length, dataset.left_index,
                dataset.right_index, warp_impl=warp_impl,
                slope_bound=slope_bound)
        else:
            imgs, mask, anns = (dev_b['image'], dev_b['mask_miss'],
                                dev_b['anns'])
        targets = encode_targets(anns, np.asarray(skeleton.sigmas),
                                 skeleton.skeleton, out_hw, out_hw, enc_cfg)
        return imgs, targets, downscale_mask(mask, enc_cfg)


def main(argv=None) -> Dict:
    """Trains; returns a summary: `steps`, `checkpoint` (the last path
    written; None on ranks other than 0), `history` (one record per
    printed step: the losses, `skipped`, `host_wait_s`, `feed_s`,
    `imgs_per_sec`, the host clock `t` after the step finished and, on a
    CUDA device, `feed_ms` and `step_ms` by CUDA events over the printed
    interval), `val` (one record per validation pass: `epoch`, `loss`,
    `batches`), `device`, `model_cfg`, the trained `model`, `rank` /
    `world`, `unmatched` (the warm start's unmatched entries, or None) and
    `frozen` (the names of the frozen parameters). With
    `--distributed` the losses are the global batch's on every rank, and
    the process group is left at the end, also on an error."""
    args = cli(argv)
    if not args.distributed:
        from ..device import resolve_device
        return train(args, resolve_device(args.device))
    from ..parallel import distributed
    dev = distributed.init_distributed(
        args.coordinator_address, args.num_processes, args.process_id,
        args.device, args.share_device)
    try:
        return train(args, dev)
    finally:
        distributed.destroy()


def train(args, dev) -> Dict:
    """`main` on the parsed flags and the resolved device (in the process
    group already where `--distributed`)."""
    # torch is imported here, not at the top: loader processes re-import
    # this module when it is the main one, and need no torch
    import torch
    from ..config.defaults import (AugmentationConfig, EncoderConfig,
                                   HeadsConfig, LossConfig, SkeletonConfig,
                                   TrainConfig)
    from ..data.pipeline import CocoKeypoints, batch_iterator
    from ..models import PoseNet
    from ..models import checkpoint as ckpt
    from ..models.network import init_reference_
    from ..parallel import distributed as D
    from ..parallel.train_step import (TrainStep, make_eval_step,
                                       make_optimizer, step_lr_schedule)
    from ..utils.logging import configure, log_record
    from ..utils.meters import AverageMeter, Throughput

    primary = D.is_primary()
    configure(args.log_file if primary else None, quiet=not primary)
    logger = logging.getLogger('train')
    cuda = dev.type == 'cuda'
    group = D.group()
    if args.batch_size % D.world():
        raise ValueError(f'--batch-size {args.batch_size} does not divide '
                         f'by {D.world()} processes')

    skeleton = SkeletonConfig.for_dataset(args.dataset, args.n_limbs)
    heads = HeadsConfig(
        n_keypoints=skeleton.n_keypoints, n_limbs=skeleton.n_limbs,
        include_background=not args.no_background,
        include_jitter_offset=not args.no_jitter_offset,
        include_scale=not args.no_scale)
    model_cfg = model_config(args, heads)
    enc_cfg = EncoderConfig(max_persons=args.max_persons, sigma=args.sigma,
                            gaussian_clip=args.gaussian_clip,
                            fill_jitter_size=args.fill_jitter_size,
                            fill_scale_size=args.fill_scale_size)
    loss_cfg = LossConfig(
        heatmap_loss=args.hmp_loss, offset_loss=args.offset_loss,
        jitter_loss=args.jitter_offset_loss, scale_loss=args.scale_loss,
        fgamma=args.fgamma, ftao=args.ftao, lambdas=tuple(args.lambdas),
        offset_margin=args.lmargin, scale_margin=args.scale_margin,
        sqrt_re=args.sqrt_re,
        stack_weights=(tuple(args.stack_weights) if args.stack_weights
                       else (1.0,) * args.n_stacks))
    train_cfg = TrainConfig(optimizer=args.optimizer,
                            opt_state_dtype=args.opt_state_dtype,
                            learning_rate=args.lr, momentum=args.momentum,
                            weight_decay=args.weight_decay,
                            epochs=args.epochs, batch_size=args.batch_size,
                            warmup_epochs=args.warmup_epochs,
                            square_length=args.square_length,
                            checkpoint_dir=args.checkpoint_dir,
                            seed=args.seed)
    aug_cfg = AugmentationConfig(
        square_length=args.square_length, flip_prob=args.flip_prob,
        max_rotate=args.max_rotate, min_scale=args.min_scale,
        max_scale=args.max_scale, min_stretch=args.min_stretch,
        max_stretch=args.max_stretch, max_translate=args.max_translate)
    dataset = CocoKeypoints(
        args.train_image_dir, args.train_annotations, skeleton=skeleton,
        aug=aug_cfg, square_length=args.square_length,
        max_persons=args.max_persons, n_images=args.n_images,
        device_aug=args.device_aug, raw_canvas=args.raw_canvas)
    steps_per_epoch = max(len(dataset) // args.batch_size, 1)
    logger.info('dataset: %d images, %d steps/epoch, device %s, %d '
                'process(es)', len(dataset), steps_per_epoch, dev, D.world())

    model = init_reference_(PoseNet(model_cfg),
                            torch.Generator().manual_seed(args.seed))
    unmatched = None
    if args.torch_checkpoint:
        unmatched = ckpt.load_reference_into(model, args.torch_checkpoint)
        logger.info('torch warm start from %s (%d unmatched entries keep '
                    'their fresh init)', args.torch_checkpoint,
                    len(unmatched))
    frozen = []
    if args.freeze:
        frozen = ckpt.frozen_parameters(model, args.freeze)
        logger.info('--freeze %r: %d of %d parameter tensors frozen',
                    args.freeze, len(frozen),
                    len(list(model.parameters())))
    model = model.to(dev, memory_format=torch.channels_last)
    optimizer = make_optimizer(train_cfg, model.parameters())
    start_step, start_epoch = 0, 0
    if args.resume:
        start_step, start_epoch, _ = ckpt.load_checkpoint(
            args.resume, model, optimizer,
            drop_optimizer=args.drop_optim_state,
            drop_layers=args.drop_layers, recount_epoch=args.recount_epoch)
        logger.info('resumed from %s at epoch %d, step %d', args.resume,
                    start_epoch, start_step)
    params = dict(model.named_parameters())
    train_step = TrainStep(model, optimizer, loss_cfg,
                           step_lr_schedule(train_cfg, steps_per_epoch),
                           train_cfg.loss_explosion_guard, args.max_grad_norm,
                           group=group, frozen=[params[n] for n in frozen])
    train_step.step = start_step

    from ..ops.augment import warp_slope_bound
    slope_bound = warp_slope_bound(aug_cfg)

    def feed(batch):
        """This rank's slice of a global host batch, on the device."""
        return device_batch(D.local_batch(batch), dataset, dev, enc_cfg,
                            skeleton, args.square_length, args.warp_impl,
                            slope_bound)

    def save(epoch):
        """Rank 0 writes the checkpoint; every rank waits for it."""
        path = (ckpt.save_checkpoint(args.checkpoint_dir, model, optimizer,
                                     train_step.step, epoch, meter.avg)
                if primary else None)
        D.barrier()
        return path

    val_dataset = None
    if args.val_image_dir and args.val_annotations:
        val_dataset = CocoKeypoints(
            args.val_image_dir, args.val_annotations, skeleton=skeleton,
            aug=None, square_length=args.square_length,
            max_persons=args.max_persons)
        eval_step = make_eval_step(model, loss_cfg, group)
    val_history = []

    def run_validation(epoch):
        """Mean validation loss over the unaugmented samples, logged as the
        `val` record."""
        vmeter = AverageMeter()
        for vb in batch_iterator(val_dataset, args.batch_size, seed=1,
                                 shuffle=False, epochs=1):
            losses = eval_step(*feed(vb))
            vmeter.update(float(losses['total']))
        log_record(logger, 'val', type='val', epoch=epoch, loss=vmeter.avg)
        val_history.append(dict(epoch=epoch, loss=vmeter.avg,
                                batches=vmeter.count))
        return vmeter.avg

    def event():
        if not cuda:
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    meter = AverageMeter()
    tput = Throughput()
    history = []
    path = None
    step = 0
    epoch = start_epoch
    host_wait = feed_time = 0.0     # blocked on the loader; put + aug/encode
    spans = []                      # CUDA events (feed start, step, end)
    it = batch_iterator(dataset, args.batch_size, seed=args.seed,
                        epochs=args.epochs - start_epoch,
                        num_workers=args.loader_workers)
    try:
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                if (epoch - start_epoch) % args.save_every != 0:
                    path = save(epoch)
                    logger.info('final checkpoint %s', path)
                break
            t1 = time.perf_counter()
            e0 = event()
            images, targets, mask = feed(batch)
            e1 = event()
            t2 = time.perf_counter()
            host_wait += t1 - t0
            feed_time += t2 - t1
            metrics = train_step(images, targets, mask)
            spans.append((e0, e1, event()))
            step += 1
            tput.tick(args.batch_size)
            last = args.max_steps is not None and step >= args.max_steps
            if step % args.print_freq == 0 or last:
                m = {k: float(v) for k, v in metrics.items()}
                rec = dict(step=step, epoch=epoch, **m,
                           imgs_per_sec=round(tput.rate, 2),
                           host_wait_s=round(host_wait, 4),
                           feed_s=round(feed_time, 4),
                           t=time.perf_counter())
                if cuda:
                    spans[-1][2].synchronize()
                    rec['feed_ms'] = sum(a.elapsed_time(b) for a, b, _ in spans)
                    rec['step_ms'] = sum(b.elapsed_time(c) for _, b, c in spans)
                spans = []
                history.append(rec)
                meter.update(m['total'])
                log_record(logger, 'train', type='train', epoch=epoch,
                           step=step, loss=m['total'], head_losses=m,
                           imgs_per_sec=rec['imgs_per_sec'],
                           host_wait_s=rec['host_wait_s'],
                           feed_s=rec['feed_s'])
                host_wait = feed_time = 0.0
            if last:
                path = save(epoch)
                logger.info('max-steps reached, checkpoint %s', path)
                break
            if step % steps_per_epoch == 0:
                epoch += 1
                if val_dataset is not None:
                    logger.info('epoch %d val loss %.4f', epoch,
                                run_validation(epoch))
                if (epoch - start_epoch) % args.save_every == 0:
                    path = save(epoch)
                    logger.info('epoch %d done, checkpoint %s', epoch, path)
                meter.reset()
    finally:
        it.close()
    return dict(steps=step, checkpoint=path, history=history,
                val=val_history, device=str(dev), model_cfg=model_cfg,
                model=model, rank=D.rank(), world=D.world(),
                unmatched=unmatched, frozen=frozen)


if __name__ == '__main__':
    main()
