"""Serving: closed-loop clients on the port's `cli/serve.py::Batcher`.

Set-up builds the server's infer with `build_infer` from the serve CLI's
own flags (the configuration's decoder settings, the traffic's batch,
window, long edge, flip and decode route) over the benchmark's seeded
weights, paints the traffic's scenes and preprocesses them with the
port's `preprocess_eval`, and warms the one batch shape. The window runs
`concurrency` client threads, each submitting its next frame when the
last one's poses come back, while `tap.Tap` copies a few of the batches
the window runs. After the window those copies are checked stage by stage
(`stages.py`), and a seeded sample of the answered requests is compared
with the program's decoded poses of its scene, mapped back to the scene
by the reference.
"""
from __future__ import annotations

import gc
import threading
import time

import numpy as np
import torch

import compare
import reference
import stages
from harness import (SEED_SAMPLE, SEED_SCENES, derive, make_state,
                     model_config)
from loadgen import closed_loop
from scenes import make_scenes, rng_for
from tap import Tap
from trace import Spans


def serve_argv(cfg, tr) -> list:
    d = cfg['decoder']
    argv = ['--dataset', cfg['dataset'], '--long-edge', str(tr['long_edge']),
            '--batch-size', str(tr['batch']),
            '--batch-window-ms', str(tr['window_ms']),
            '--topk', str(d['topk']), '--thre-hmp', str(d['thre_hmp']),
            '--dist-max', str(d['dist_max']),
            '--person-thre', str(d['person_thre']),
            '--min-len', str(d['min_len']), '--sort-dim', str(d['sort_dim']),
            '--resize-mode', d['resize_mode']]
    if tr.get('lowres'):
        argv.append('--lowres-decode')
    if tr.get('flip'):
        argv.append('--flip-test')
    return argv


def _faulty(infer, fault: str):
    """The infer with a planted fault, for the tests of the check."""
    def broken(x):
        poses, scores, counts = infer(x)
        if fault == 'half_batch':           # the second half answers nothing
            counts = counts.clone()
            counts[counts.shape[0] // 2:] = 0
        elif fault == 'altered':            # one answer shifted by 3 px
            poses = poses.clone()
            poses[0, :, :, 0] += 3.0
        return poses, scores, counts
    broken.model, broken.postprocessor = infer.model, infer.postprocessor
    return broken


def setup(ctx) -> dict:
    from offsetguided_tpu_torch.cli import serve as S
    from offsetguided_tpu_torch.config.defaults import (EvalConfig,
                                                        SkeletonConfig)
    from offsetguided_tpu_torch.eval.harness import preprocess_eval

    cfg, tr, dev = ctx.cfg, ctx.traffic, torch.device(ctx.device)
    scenes = make_scenes(tr, derive(ctx.seed, SEED_SCENES))
    sd = make_state(cfg, tr, ctx.seed, dev)
    if dev.type == 'cuda':
        from offsetguided_tpu_torch.ops.cuda import _build
        _build.build_all()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    sargs = S.cli(serve_argv(cfg, tr))
    skel = SkeletonConfig.for_dataset(cfg['dataset'])
    if (list(skel.keypoints) != cfg['keypoints']
            or [list(l) for l in skel.skeleton] != cfg['skeleton']):
        raise ValueError('the port skeleton differs from the configuration')
    if ctx.control == 'fp8':
        infer = reference.make_infer(
            cfg, {k: v.to(dev) for k, v in sd.items()}, tr.get('flip', False),
            tr.get('lowres', False), fp8=True)
    else:
        infer, _, _, _ = S.build_infer(sargs, model_config(cfg), sd, dev)
    if ctx.fault:
        infer = _faulty(infer, ctx.fault)
    eval_cfg = EvalConfig(long_edge=tr['long_edge'],
                          flip_test=tr.get('flip', False),
                          batch_size=tr['batch'])
    J = len(cfg['keypoints'])
    frames, metas = [], []
    for img, _ in scenes:
        f, _, meta = preprocess_eval(img, np.zeros((0, J, 4), np.float32),
                                     eval_cfg, J)
        frames.append(f)
        metas.append(meta)
    tc = tr['tap']
    k0 = int(rng_for(derive(ctx.seed, SEED_SAMPLE), 1).randint(tc['first']))

    def select(n, k0=k0, step=tc['step'], count=tc['count']):
        return n >= k0 and (n - k0) % step == 0 and (n - k0) // step < count

    tap = Tap(infer.model, infer.postprocessor, select, cfg['pixel_mean'],
              cfg['pixel_std'], tr.get('flip', False))
    spans = None
    if ctx.capture is not None:
        spans = Spans(infer.model, infer.postprocessor, ctx.capture)
    bs = tr['batch']
    warm = torch.from_numpy(np.stack([frames[i % len(frames)]
                                      for i in range(bs)])).to(dev)
    for _ in range(2):
        infer(warm)[2].cpu()
    tap.warm(lambda: [infer(warm) for _ in range(tc['count'])])
    batcher = S.Batcher(infer, bs, tr['window_ms'], dev)
    threads = [threading.Thread(target=batcher.submit,
                                args=(frames[i], metas[i]))
               for i in range(bs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return dict(ctx=ctx, scenes=scenes, sd=sd, infer=infer, batcher=batcher,
                frames=frames, metas=metas, spans=spans, tap=tap)


def window(st: dict, seconds: float) -> dict:
    b, frames, metas = st['batcher'], st['frames'], st['metas']
    tr = st['ctx'].traffic
    r0, n0 = b.n_requests, b.n_batches
    st['tap'].arm()
    reqs, t0, t1 = closed_loop(lambda i: b.submit(frames[i], metas[i]),
                               len(frames), tr['concurrency'], seconds)
    cap = st['ctx'].capture
    if cap is not None:
        # the profiled stretch ends at the close, on the batcher's thread
        cap.t_stop = time.perf_counter()
        b.submit(frames[0], metas[0])
    st['tap'].disarm()
    return dict(requests=reqs, t0=t0, t1=t1, d_requests=b.n_requests - r0,
                d_batches=b.n_batches - n0)


def release(st: dict) -> None:
    st['batcher'].close()
    for k in ('infer', 'batcher', 'spans'):
        st[k] = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def record(st: dict, out: dict) -> dict:
    """What the metric readers read."""
    ctx, tr = st['ctx'], st['ctx'].traffic
    # a traced run's rates are read before the profiled stretch
    t1 = out['t1'] if ctx.capture is None else ctx.capture.t_start
    in_window = [r for r in out['requests'] if r.t_done <= t1]
    lats = [r.t_done - r.t_submit if not r.error else float('inf')
            for r in in_window]
    n = tr['long_edge']
    done = sum(1 for r in in_window if not r.error)
    return dict(seconds=t1 - out['t0'], latencies=lats, images=done,
                t0=out['t0'], done_at=[(r.t_done, 1) for r in out['requests']
                                       if not r.error],
                images_by_shape={(n, n): done},
                flip=bool(tr.get('flip')), requests=out['d_requests'],
                batches=out['d_batches'], cfg=ctx.cfg)


def check(st: dict, out: dict) -> tuple:
    """-> (numbers, attempted, failed, diagnostics)."""
    ctx, tr = st['ctx'], st['ctx'].traffic
    dev = torch.device(ctx.device)
    canvases = {i: reference.pad_long_edge(img, tr['long_edge'])
                for i, (img, _) in enumerate(st['scenes'])}
    numbers, prog, diag = stages.stage_numbers(
        ctx.cfg, st['sd'], st['tap'].calls, canvases, tr.get('flip', False),
        tr.get('lowres', False), tr['tol_px'], dev)
    reqs = out['requests']
    answered = [r for r in reqs if not r.error]
    failed = len(reqs) - len(answered)
    covered = [r for r in answered if r.item in prog]
    rng = rng_for(derive(ctx.seed, SEED_SAMPLE), 0)
    pick = rng.choice(len(covered), min(tr['n_check'], len(covered)),
                      replace=False) if covered else []
    worst = None
    for k in pick:
        r = covered[k]
        want = reference.to_image(prog[r.item], canvases[r.item][1])
        m = compare.mismatch(compare.from_poses(r.answer),
                             compare.from_poses(want), tr['tol_px'])
        worst = m if worst is None else max(worst, m)
    if worst is not None:
        numbers['answer_mismatch'] = worst
    diag['answers_checked'] = len(pick)
    return numbers, len(reqs), failed, diag
