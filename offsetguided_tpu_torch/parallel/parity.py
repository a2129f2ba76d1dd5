"""Rank workers of the data-parallel checks.

Each function here runs inside one rank of a group that
`distributed.spawn` starts (spawned processes import their target by
module path, so the workers live in the package, not in the tests). The
checks hand them numpy inputs of the global batch; each rank takes its
contiguous slice, runs the data-parallel code and returns numpy results,
which the caller holds against the same code on the whole batch in one
process, or against the JAX package:

- `batchnorm`: a synchronized `BatchNorm2d` forward + backward;
- `losses`: `compute_losses` with the global normalizers, and the
  gradient of each rank's share with respect to its predictions;
- `train_step`: one `TrainStep` of a model from given weights;
- `train_cli`: `cli/train.py --distributed` runs, one after another.

`run_cases(rank, world, port, cases, device, share_device)` joins the
group and runs a list of (name, worker, kwargs) in one spawn.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import distributed as D


def _np(t):
    return t.detach().cpu().numpy()


def batchnorm(dev, x, weight, bias, dy, running_mean, running_var,
              momentum: float = 0.1) -> Dict:
    """A synchronized `BatchNorm2d` on this rank's slice of (N, C, H, W)
    `x` with upstream gradient `dy`: this rank's output and `dx`, its
    shares of `dw` / `db`, and the running statistics after the step."""
    from ..models.layers import BatchNorm2d, sync_batchnorm
    xt = D.local_slice(torch.from_numpy(x)).to(dev).requires_grad_()
    bn = BatchNorm2d(x.shape[1], momentum=momentum).to(dev, xt.dtype)
    with torch.no_grad():
        for name, v in (('weight', weight), ('bias', bias),
                        ('running_mean', running_mean),
                        ('running_var', running_var)):
            getattr(bn, name).copy_(torch.from_numpy(v))
    sync_batchnorm(bn, D.group()).train()
    y = bn(xt)
    y.backward(D.local_slice(torch.from_numpy(dy)).to(dev, y.dtype))
    return dict(y=_np(y), dx=_np(xt.grad), dw=_np(bn.weight.grad),
                db=_np(bn.bias.grad), running_mean=_np(bn.running_mean),
                running_var=_np(bn.running_var))


def losses(dev, preds: Dict, targets: Dict, mask, loss_kw: Dict) -> Dict:
    """`compute_losses` on this rank's slice with the global normalizers:
    its shares (`local`), the global losses (`global`), and the gradient
    of its share of the total with respect to each of its predictions
    (`grads`, key -> per-stack list)."""
    from ..config.defaults import LossConfig
    from ..ops.encoder import Targets
    from ..ops.losses import compute_losses, global_losses
    p = {k: [None if a is None else
             D.local_slice(torch.from_numpy(a)).to(dev).requires_grad_()
             for a in v] for k, v in preds.items()}
    t = Targets(**{k: D.local_slice(torch.from_numpy(v)).to(dev)
                   for k, v in targets.items()})
    out = compute_losses(p, t, D.local_slice(torch.from_numpy(mask)).to(dev),
                         LossConfig(**loss_kw), D.group())
    out['total'].backward()
    return {'local': {k: float(v) for k, v in out.items()},
            'global': {k: float(v) for k, v in
                       global_losses(out, D.group()).items()},
            'grads': {k: [None if a is None else _np(a.grad) for a in v]
                      for k, v in p.items()}}


def train_step(dev, model_kw: Dict, state: Dict, images, anns, mask,
               lr: float = 1e-3, dtype: str = 'float32',
               spike_rank: int = -1, spike: float = 0.0,
               loss_kw: Dict = None, steps: int = 1, freeze: str = None,
               max_grad_norm: float = None) -> Dict:
    """One SGD `TrainStep` (momentum 0.9, the step is lr * gradient) of
    the model of `model_kw` from the weights `state`, on this rank's slice
    of the global batch, with TF32 off; targets are encoded from the
    rank's annotations (`anns` at 1/4 of the images' side, COCO skeleton)
    in `dtype`. With `spike_rank`, that rank sets one labeled heatmap
    target to `spike` (the explosion guard's test). `steps` repeats the
    step on the same batch. `freeze` (a `--freeze` regex) and
    `max_grad_norm` are the trainer's flags. Returns the last metrics, the
    weights after the steps and their digest. Without a process group it
    is the one-process step on the whole batch."""
    from ..device import exact_fp32
    with exact_fp32():
        return _train_step(dev, model_kw, state, images, anns, mask, lr,
                           dtype, spike_rank, spike, loss_kw, steps, freeze,
                           max_grad_norm)


def _train_step(dev, model_kw, state, images, anns, mask, lr, dtype,
                spike_rank, spike, loss_kw, steps, freeze, max_grad_norm):
    from ..config.coco import COCO_PERSON_SIGMAS, COCO_PERSON_SKELETON
    from ..config.defaults import (EncoderConfig, HeadsConfig, LossConfig,
                                   ModelConfig, TrainConfig)
    from ..models import PoseNet
    from ..models.checkpoint import frozen_parameters
    from ..ops.encoder import encode_targets
    from .train_step import TrainStep, make_optimizer
    kw = dict(model_kw, compute_dtype=dtype)
    kw['heads'] = HeadsConfig(**kw.get('heads', {}))
    net = PoseNet(ModelConfig(**kw))
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()},
                        strict=True)
    net = net.to(dev, getattr(torch, dtype))
    imgs = D.local_slice(torch.from_numpy(images)).to(dev)
    out = images.shape[1] // 4
    tg = encode_targets(D.local_slice(torch.from_numpy(anns)).to(dev),
                        COCO_PERSON_SIGMAS, COCO_PERSON_SKELETON, out, out,
                        EncoderConfig(max_persons=anns.shape[1]))
    tg = type(tg)(*[t.to(getattr(torch, dtype)) for t in tg])
    if D.rank() == spike_rank:
        tg.hmp[0, 5, 5, 3] = spike
    opt = make_optimizer(TrainConfig(optimizer='sgd', learning_rate=lr),
                         net.parameters())
    params = dict(net.named_parameters())
    step = TrainStep(net, opt, LossConfig(stack_weights=(1.0,),
                                          **(loss_kw or {})),
                     max_grad_norm=max_grad_norm, group=D.group(),
                     frozen=[params[n] for n in frozen_parameters(
                         net, freeze)] if freeze else ())
    for _ in range(steps):
        m = step(imgs, tg, D.local_slice(torch.from_numpy(mask)).to(dev))
    return dict(metrics={k: float(v) for k, v in m.items()},
                state={k: _np(v) for k, v in net.state_dict().items()},
                digest=D.state_digest(net))


def step_errors(state: Dict, ref: Dict, got: Dict, lr: float = 1e-3) -> Dict:
    """Two `train_step` results from the weights `state` held as the
    one-step tests hold them: the largest relative loss error, the
    gradient error (the step over lr: |diff| - 1e-3 |g|, over the largest
    gradient), the BatchNorm statistics' error, and both skipped flags."""
    mr, mg = ref['metrics'], got['metrics']
    loss = max(abs(mg[k] - mr[k]) / max(abs(mr[k]), 1e-12) for k in mr)
    grads = [((state[k] - ref['state'][k]) / lr,
              (state[k] - got['state'][k]) / lr)
             for k in state if k.endswith(('weight', 'bias'))]
    gmax = max(float(np.abs(a).max()) for a, _ in grads)
    grad = max(float((np.abs(b - a) - 1e-3 * np.abs(a)).max())
               for a, b in grads) / gmax
    bn = max(float(np.abs(got['state'][k] - ref['state'][k]).max())
             for k in state if 'running' in k)
    return dict(loss=loss, grad=grad, grad_max=gmax, bn=bn,
                skipped=(mr['skipped'], mg['skipped']))


WORKERS = {'batchnorm': batchnorm, 'losses': losses,
           'train_step': train_step}


def run_cases(rank: int, world: int, port: int,
              cases: Sequence[Tuple[str, str, Dict]], device: str = 'cpu',
              share_device: bool = True, threads: int = 2) -> Dict:
    """`distributed.spawn` target: join the group, run each (name,
    worker, kwargs) of `cases` on this rank, leave the group; returns
    {name: result}."""
    torch.set_num_threads(threads)
    dev = D.init_distributed(f'localhost:{port}', world, rank, device,
                             share_device)
    try:
        return {name: WORKERS[worker](dev, **kw)
                for name, worker, kw in cases}
    finally:
        D.destroy()


def train_cli(rank: int, world: int, port: int,
              runs: List[Tuple[List[str], int]], threads: int = 2,
              with_state: bool = True) -> List:
    """`distributed.spawn` target: `cli/train.py --distributed` once for
    each (argv, port) of `runs`, in order (each run its own group, met at
    its own localhost port). Returns per run the summary's `steps`,
    `checkpoint`, `history`, `rank` and `world`, the wall time of the
    call, the final weights' digest, the card's peak memory (GiB, 0 on
    the CPU) and, with `with_state`, the final weights."""
    import time
    from ..cli import train
    torch.set_num_threads(threads)
    out = []
    for argv, run_port in runs:
        t0 = time.perf_counter()
        r = train.main(list(argv) + [
            '--distributed', '--coordinator-address',
            f'localhost:{run_port}', '--num-processes', str(world),
            '--process-id', str(rank)])
        dev = torch.device(r['device'])
        peak = 0.0
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        rec = dict({k: r[k] for k in ('steps', 'checkpoint', 'history',
                                      'rank', 'world')},
                   wall_s=time.perf_counter() - t0, peak_gib=peak,
                   digest=D.state_digest(r['model']))
        if with_state:
            rec['state'] = {k: _np(v)
                            for k, v in r['model'].state_dict().items()}
        out.append(rec)
    return out
