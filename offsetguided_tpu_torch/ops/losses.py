"""Training losses: focal-L2 heatmaps, masked L1 offset and scale regression.

Port of the JAX package's `ops/losses.py`. Every loss is masked elementwise
arithmetic over the full fixed-shape maps; +inf / NaN targets (unlabeled
texels) are excluded by an isfinite mask. The per-element margin filters
and the `sum / (1 + count)` normalizations count the KEPT elements. The
sqrt of the offset losses is taken only where an element is kept (`where`
first), so masked zeros give finite gradients.
"""
from __future__ import annotations

from typing import Dict, List

import torch

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


def _margin_normalized_sum(elems, valid, margin, sqrt_re):
    """Keep elements >= margin, optional sqrt, sum / (1 + count)."""
    keep = valid & (elems >= margin)
    if sqrt_re:
        vals = torch.sqrt(torch.where(keep, elems, torch.ones_like(elems)))
    else:
        vals = elems
    total = torch.where(keep, vals, torch.zeros_like(vals)).sum()
    return total / (1.0 + keep.sum().to(total.dtype))


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
                   cfg: LossConfig) -> Dict[str, torch.Tensor]:
    """All loss components, stack-weighted and divided by the batch.

    preds: PoseNet output dict of per-stack NHWC maps; targets:
    ops.encoder.Targets (batched); mask_miss: (N, Ho, Wo, 1) bool.
    Returns scalars hmp, bg, jomp, omp, scmp (0 for absent heads) and
    'total', their lambda-weighted sum."""
    n_stacks = len(preds['hmp'])
    w = [wi / sum(cfg.stack_weights[:n_stacks])
         for wi in cfg.stack_weights[:n_stacks]]
    batch = targets.hmp.shape[0]
    hmp_fn = heatmap_loss_fn(cfg.heatmap_loss, cfg)
    zero = targets.hmp.new_zeros(())

    out = {k: zero for k in LOSS_KEYS}
    for s in range(n_stacks):
        out['hmp'] = out['hmp'] + w[s] * _masked_sum(
            preds['hmp'][s], targets.hmp, mask_miss, hmp_fn)
        if preds['bg'][s] is not None:
            out['bg'] = out['bg'] + w[s] * _masked_sum(
                preds['bg'][s], targets.bg, mask_miss, hmp_fn)
        if preds['jomp'][s] is not None:
            elems, valid = offset_elems(cfg.jitter_loss, preds['jomp'][s],
                                        targets.jomp, None, None, mask_miss)
            out['jomp'] = out['jomp'] + w[s] * _margin_normalized_sum(
                elems, valid, cfg.offset_margin, cfg.sqrt_re)
        elems, valid = offset_elems(
            cfg.offset_loss, preds['omp'][s], targets.omp, targets.pscmp,
            preds['spread'][s], mask_miss)
        out['omp'] = out['omp'] + w[s] * _margin_normalized_sum(
            elems, valid, cfg.offset_margin, cfg.sqrt_re)
        if preds['scmp'][s] is not None:
            valid = _valid_mask(targets.scmp, mask_miss)
            gt_safe = torch.where(valid, targets.scmp,
                                  torch.zeros_like(targets.scmp))
            elems = _l1(preds['scmp'][s], gt_safe)
            out['scmp'] = out['scmp'] + w[s] * _margin_normalized_sum(
                elems, valid, cfg.scale_margin, cfg.sqrt_re)

    out = {k: v / batch for k, v in out.items()}
    lam = cfg.lambdas
    out['total'] = (lam[0] * out['hmp'] + lam[1] * out['bg']
                    + lam[2] * out['jomp'] + lam[3] * out['omp']
                    + lam[4] * out['scmp'])
    return out
