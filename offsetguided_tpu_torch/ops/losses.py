"""Training losses: focal-L2 heatmaps, masked L1 offset and scale regression.

Port of the JAX package's `ops/losses.py`. Every loss is masked elementwise
arithmetic over the full fixed-shape maps; +inf / NaN targets (unlabeled
texels) are excluded by an isfinite mask. The per-element margin filters
and the `sum / (1 + count)` normalizations count the KEPT elements. The
sqrt of the offset losses is taken only where an element is kept (`where`
first), so masked zeros give finite gradients.

Data parallel (`compute_losses(..., group=...)`): each rank's losses are
its own sums over the GLOBAL normalizers (the kept counts of every
`sum / (1 + count)` and the batch size, all-reduced together once), so the
ranks' losses add up to the loss of the whole batch, as the JAX trainer's
jit computes it over the sharded batch; `global_losses` sums them for
reporting.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist

from ..config.defaults import LossConfig

LOSS_KEYS = ('hmp', 'bg', 'jomp', 'omp', 'scmp')


def _l1(pred, gt):
    return (pred - gt).abs()


def _l2(pred, gt):
    return 0.5 * (pred - gt) ** 2


def _focal_l2(pred, gt, tau, gamma):
    st = torch.where(gt >= tau, pred, 1.0 - pred)
    factor = (1.0 - st).abs() ** gamma
    return 0.5 * (pred - gt) ** 2 * factor


def _valid_mask(gt, mask_miss):
    """mask_miss broadcast & isfinite(gt)."""
    return mask_miss & torch.isfinite(gt)


def _masked_sum(pred, gt, mask_miss, fun):
    """Sum of fun(pred, gt) over labeled texels."""
    valid = _valid_mask(gt, mask_miss)
    gt_safe = torch.where(valid, gt, torch.zeros_like(gt))
    elems = fun(pred, gt_safe)
    return torch.where(valid, elems, torch.zeros_like(elems)).sum()


def _margin_sum(elems, valid, margin, sqrt_re):
    """Keep elements >= margin, optional sqrt: (sum, count kept)."""
    keep = valid & (elems >= margin)
    if sqrt_re:
        vals = torch.sqrt(torch.where(keep, elems, torch.ones_like(elems)))
    else:
        vals = elems
    return torch.where(keep, vals, torch.zeros_like(vals)).sum(), keep.sum()


def heatmap_loss_fn(name: str, cfg: LossConfig):
    if name == 'l2':
        return _l2
    if name == 'focal_l2':
        return lambda p, g: _focal_l2(p, g, cfg.ftao, cfg.fgamma)
    raise ValueError(f'unknown heatmap loss: {name}')


def offset_elems(name: str, pred, gt_off, gt_ps, spread, mask_miss):
    """Per-element offset loss and its validity mask: (elems, valid)."""
    if name == 'offset_l1':
        valid = _valid_mask(gt_off, mask_miss)
        gt_safe = torch.where(valid, gt_off, torch.zeros_like(gt_off))
        return _l1(pred, gt_safe), valid
    if name == 'offset_instance_l1':
        valid = _valid_mask(gt_off, mask_miss)
        gt_safe = torch.where(valid, gt_off, torch.zeros_like(gt_off))
        ps = torch.where(valid, gt_ps, torch.ones_like(gt_ps))
        return _l1(pred / ps, gt_safe / ps), valid
    if name == 'offset_laplace':
        # vector-norm laplace over (x, y) pairs with inferred log-spread b
        n, h, w, c2 = pred.shape
        finite = torch.where(torch.isfinite(gt_off), gt_off,
                             torch.zeros_like(gt_off))
        d = (pred - finite).reshape(n, h, w, c2 // 2, 2)
        norm = torch.linalg.norm(d, dim=-1)
        valid = (_valid_mask(gt_off, mask_miss)
                 .reshape(n, h, w, c2 // 2, 2).all(dim=-1))
        return spread + norm * torch.exp(-spread), valid
    raise ValueError(f'unknown offset loss: {name}')


def compute_losses(preds: Dict[str, List], targets, mask_miss: torch.Tensor,
                   cfg: LossConfig, group=None) -> Dict[str, torch.Tensor]:
    """All loss components, stack-weighted and divided by the batch.

    preds: PoseNet output dict of per-stack NHWC maps; targets:
    ops.encoder.Targets (batched); mask_miss: (N, Ho, Wo, 1) bool.
    Returns scalars hmp, bg, jomp, omp, scmp (0 for absent heads) and
    'total', their lambda-weighted sum. With a process `group`, the
    normalizers (kept counts and batch) are the global batch's, so each
    value is this rank's share of the global loss (`global_losses` adds
    the shares up)."""
    n_stacks = len(preds['hmp'])
    w = [wi / sum(cfg.stack_weights[:n_stacks])
         for wi in cfg.stack_weights[:n_stacks]]
    hmp_fn = heatmap_loss_fn(cfg.heatmap_loss, cfg)
    zero = targets.hmp.new_zeros(())

    # (key, stack weight, sum, kept count or None): the counts are
    # normalized below, all at once
    terms = []
    for s in range(n_stacks):
        terms.append(('hmp', w[s], _masked_sum(
            preds['hmp'][s], targets.hmp, mask_miss, hmp_fn), None))
        if preds['bg'][s] is not None:
            terms.append(('bg', w[s], _masked_sum(
                preds['bg'][s], targets.bg, mask_miss, hmp_fn), None))
        if preds['jomp'][s] is not None:
            elems, valid = offset_elems(cfg.jitter_loss, preds['jomp'][s],
                                        targets.jomp, None, None, mask_miss)
            terms.append(('jomp', w[s], *_margin_sum(
                elems, valid, cfg.offset_margin, cfg.sqrt_re)))
        elems, valid = offset_elems(
            cfg.offset_loss, preds['omp'][s], targets.omp, targets.pscmp,
            preds['spread'][s], mask_miss)
        terms.append(('omp', w[s], *_margin_sum(
            elems, valid, cfg.offset_margin, cfg.sqrt_re)))
        if preds['scmp'][s] is not None:
            valid = _valid_mask(targets.scmp, mask_miss)
            gt_safe = torch.where(valid, targets.scmp,
                                  torch.zeros_like(targets.scmp))
            elems = _l1(preds['scmp'][s], gt_safe)
            terms.append(('scmp', w[s], *_margin_sum(
                elems, valid, cfg.scale_margin, cfg.sqrt_re)))

    counted = [t[3] for t in terms if t[3] is not None]
    batch = targets.hmp.shape[0]
    if group is not None:
        with torch.no_grad():
            norms = torch.stack([c.to(torch.float64) for c in counted]
                                + [zero.new_tensor(batch, dtype=torch.float64)])
            dist.all_reduce(norms, group=group)
        counted, batch = list(norms[:-1]), norms[-1].to(zero.dtype)
    counts = iter(counted)
    out = {k: zero for k in LOSS_KEYS}
    for key, ws, total, count in terms:
        if count is not None:
            total = total / (1.0 + next(counts).to(total.dtype))
        out[key] = out[key] + ws * total

    out = {k: v / batch for k, v in out.items()}
    lam = cfg.lambdas
    out['total'] = (lam[0] * out['hmp'] + lam[1] * out['bg']
                    + lam[2] * out['jomp'] + lam[3] * out['omp']
                    + lam[4] * out['scmp'])
    return out


def global_losses(losses: Dict[str, torch.Tensor],
                  group=None) -> Dict[str, torch.Tensor]:
    """The ranks' shares of each loss (`compute_losses` with a group)
    added up, detached: the global batch's losses on every rank, by one
    all-reduce. Without a group, the losses detached."""
    keys = sorted(losses)
    if group is None:
        return {k: losses[k].detach() for k in keys}
    vals = torch.stack([losses[k].detach() for k in keys])
    dist.all_reduce(vals, group=group)
    return dict(zip(keys, vals.unbind()))
