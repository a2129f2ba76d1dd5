"""Evaluation from disk: the port's `eval/harness.py::run_images`.

Set-up paints the traffic's scenes, writes them with their image list
under TMPDIR as `.npy` files (uint8 RGB, which the port reads with numpy:
no codec in the window), builds the network as
`cli/evaluate.py` builds it (state dict, `prepare_inference`,
`PostProcessor` of the configuration's decoder settings) over the
benchmark's seeded weights, and runs one pass to warm every padded shape.
The window repeats passes over the scenes until its time is up; it ends
with the pass that crosses the mark. `tap.Tap` copies every call of the
window's first pass; after the window those copies are checked stage by
stage (`stages.py`), and every image's records of every pass are
compared with the records the reference makes from the program's decoded
poses of that scene.
"""
from __future__ import annotations

import gc
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

import compare
import reference
import stages
from harness import SEED_SCENES, derive, make_state, model_config
from scenes import make_scenes
from tap import Tap
from trace import Spans


def _write(scenes, root: str) -> tuple:
    """The scenes as `.npy` files, with their image list."""
    img_dir = os.path.join(root, 'images')
    os.makedirs(img_dir)
    images = []
    for i, (img, _) in enumerate(scenes, start=1):
        name = f'{i:06d}.npy'
        np.save(os.path.join(img_dir, name), img)
        images.append({'id': i, 'file_name': name,
                       'height': int(img.shape[0]),
                       'width': int(img.shape[1])})
    ann = os.path.join(root, 'annotations.json')
    with open(ann, 'w') as f:
        json.dump({'images': images, 'annotations': [],
                   'categories': [{'id': 1, 'name': 'person'}]}, f)
    return img_dir, ann


def setup(ctx) -> dict:
    from offsetguided_tpu_torch.config.defaults import (DecoderConfig,
                                                        EvalConfig,
                                                        SkeletonConfig)
    from offsetguided_tpu_torch.data.coco import CocoJson
    from offsetguided_tpu_torch.decoder import PostProcessor
    from offsetguided_tpu_torch.eval.harness import run_images
    from offsetguided_tpu_torch.models import PoseNet

    cfg, tr, dev = ctx.cfg, ctx.traffic, torch.device(ctx.device)
    scenes = make_scenes(tr, derive(ctx.seed, SEED_SCENES))
    tmp = tempfile.mkdtemp(prefix='bench-eval-')
    img_dir, ann = _write(scenes, tmp)
    sd = make_state(cfg, tr, ctx.seed, dev)
    if dev.type == 'cuda':
        from offsetguided_tpu_torch.ops.cuda import _build
        _build.build_all()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    skel = SkeletonConfig.for_dataset(cfg['dataset'])
    if (list(skel.keypoints) != cfg['keypoints']
            or [list(l) for l in skel.skeleton] != cfg['skeleton']):
        raise ValueError('the port skeleton differs from the configuration')
    if ctx.control == 'fp8':
        ref = reference.make_infer(
            cfg, {k: v.to(dev) for k, v in sd.items()}, True,
            tr.get('lowres', False), fp8=True)
        model, pp = ref.model, ref.postprocessor
    else:
        model = PoseNet(model_config(cfg))
        model.load_state_dict(sd, strict=True)
        model = model.to(dev).prepare_inference()
        d = cfg['decoder']
        pp = PostProcessor(skeleton=skel, cfg=DecoderConfig(
            topk=d['topk'], thre_hmp=d['thre_hmp'], dist_max=d['dist_max'],
            person_thre=d['person_thre'], min_len=d['min_len'],
            sort_dim=d['sort_dim'], resize_mode=d['resize_mode'],
            upsampled_decode=not tr.get('lowres', False)))
    eval_cfg = EvalConfig(long_edge=tr['long_edge'], fixed_height=True,
                          max_stride=tr['max_stride'],
                          width_bucket=tr['width_bucket'],
                          flip_test=tr.get('flip', False),
                          batch_size=tr['batch'],
                          io_workers=tr['io_workers'])
    coco = CocoJson(ann)

    def one_pass():
        return run_images(model, pp, coco, img_dir, eval_cfg, skeleton=skel,
                          all_images=True)

    if ctx.fault:
        one_pass = _faulty(one_pass, ctx.fault)
    per_pass = [0]
    tap = Tap(model, pp, lambda n: n < per_pass[0], cfg['pixel_mean'],
              cfg['pixel_std'], tr.get('flip', False))
    spans = None
    if ctx.capture is not None:
        spans = Spans(model, pp, ctx.capture)
    per_pass[0] = tap.warm(one_pass)    # the warm-up pass: every shape
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    return dict(ctx=ctx, scenes=scenes, sd=sd, model=model, pp=pp,
                one_pass=one_pass, tmp=tmp, spans=spans, tap=tap)


def _faulty(one_pass, fault: str):
    """A pass with a planted fault, for the tests of the check."""
    def broken():
        recs = one_pass()
        ids = sorted({r['image_id'] for r in recs})
        if fault == 'half_batch':           # half of the images left out
            drop = set(ids[::2])
            return [r for r in recs if r['image_id'] not in drop]
        if fault == 'altered':              # one image's records shifted
            for r in recs:
                if r['image_id'] == ids[0]:
                    kp = r['keypoints']
                    r['keypoints'] = [v + 3.0 if i % 3 == 0 and kp[i + 2]
                                      else v for i, v in enumerate(kp)]
        return recs
    return broken


def _by_image(recs: list) -> dict:
    """A pass's records as image id -> one array of their keypoints, so
    that the window holds a few arrays a pass and not thousands of
    objects for the collector to walk."""
    by_id = {}
    for r in recs:
        by_id.setdefault(r['image_id'], []).append(r)
    return {i: compare.rows_of(rs) for i, rs in by_id.items()}


def window(st: dict, seconds: float) -> dict:
    passes, ends = [], []
    st['tap'].arm()
    t0 = time.perf_counter()
    while True:
        passes.append(_by_image(st['one_pass']()))
        ends.append(time.perf_counter())
        if ends[-1] >= t0 + seconds:
            break
    dev = torch.device(st['ctx'].device)
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    st['tap'].disarm()
    return dict(passes=passes, ends=ends, t0=t0, t1=t1)


def release(st: dict) -> None:
    for k in ('model', 'pp', 'one_pass', 'spans'):
        st[k] = None
    shutil.rmtree(st['tmp'], ignore_errors=True)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def padded_shape(h: int, w: int, tr: dict) -> tuple:
    m, b = tr['max_stride'], max(tr['width_bucket'], tr['max_stride'])
    return -(-h // m) * m, -(-w // b) * b


def record(st: dict, out: dict) -> dict:
    ctx, tr = st['ctx'], st['ctx'].traffic
    n_pass, t1 = len(out['passes']), out['t1']
    if ctx.capture is not None:
        # a traced run's rates are read over the passes before the
        # profiled stretch
        before = [t for t in out['ends'] if t <= ctx.capture.t_start]
        n_pass, t1 = len(before), (before[-1] if before else out['t0'])
    by_shape = {}
    for img, _ in st['scenes']:
        s = padded_shape(img.shape[0], img.shape[1], tr)
        by_shape[s] = by_shape.get(s, 0) + n_pass
    return dict(seconds=t1 - out['t0'],
                images=n_pass * len(st['scenes']), images_by_shape=by_shape,
                t0=out['t0'], done_at=[(t, len(st['scenes']))
                                       for t in out['ends']],
                flip=bool(tr.get('flip')), cfg=ctx.cfg)


def check(st: dict, out: dict) -> tuple:
    """-> (numbers, attempted, failed, diagnostics). An image of a pass
    without any record is failed."""
    ctx, tr = st['ctx'], st['ctx'].traffic
    dev = torch.device(ctx.device)
    J = len(ctx.cfg['keypoints'])
    bucket = max(tr['width_bucket'], tr['max_stride'])
    canvases = {i: reference.pad_fixed_height(img, tr['long_edge'],
                                              tr['max_stride'], bucket)
                for i, (img, _) in enumerate(st['scenes'], start=1)}
    numbers, prog, diag = stages.stage_numbers(
        ctx.cfg, st['sd'], st['tap'].calls, canvases, tr.get('flip', False),
        tr.get('lowres', False), tr['tol_px'], dev)
    want = {i: compare.from_records(reference.records(
        reference.to_image(p, canvases[i][1]), i), J)
        for i, p in prog.items()}
    n = len(st['scenes'])
    failed, checked, worst = 0, 0, None
    for by_id in out['passes']:
        for i in range(1, n + 1):
            if i not in by_id:
                failed += 1
            elif i in want:
                m = compare.mismatch(compare.from_records(by_id[i], J),
                                     want[i], tr['tol_px'])
                worst = m if worst is None else max(worst, m)
                checked += 1
    if worst is not None:
        numbers['answer_mismatch'] = worst
    diag['answers_checked'] = checked
    return numbers, len(out['passes']) * n, failed, diag
