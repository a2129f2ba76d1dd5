"""Greedy skeleton grouping, the plain PyTorch version.

Same algorithm and tie rules as the JAX package's `ops/grouping.py`
(`_group_single`, `_merge_pass`, `_delete_sort`), written with a batch
dimension instead of `vmap`: fixed `capacity` skeleton rows with a `used`
flag; per limb a validity gate, dedup per end keypoint, redundant-limb score
refresh, one-joint extension, one merge pass (one mergee per target), new
rows from free slots in rank order; then `settle_passes` merge passes and the
finalize. `torch.maximum` propagates NaN as `jnp.maximum` does.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..config.defaults import DecoderConfig

COL_X, COL_Y, COL_V, COL_S, COL_LSC, COL_IND = range(6)


def _first_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along `dim` (0 when there is none)."""
    return torch.argmax(mask.to(torch.uint8), dim=dim)


def _nan_argmax(v: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis, first index wins, NaN counts as largest
    (`jnp.argmax`)."""
    nan = torch.isnan(v)
    finite_max = torch.argmax(torch.where(nan, float('-inf'), v), dim=-1)
    return torch.where(nan.any(dim=-1), _first_true(nan, -1), finite_max)


def _merge_pass(subset, used):
    """subset (N, M, J, 6), used (N, M) bool."""
    n, M = used.shape
    inds = subset[..., COL_IND]                                # (N, M, J)
    shared = ((inds[:, :, None, :] == inds[:, None, :, :])
              & (inds[:, :, None, :] != -1.0)).sum(dim=-1)     # (N, Ma, Mb)
    ar = torch.arange(M, device=used.device)
    upper = ar[:, None] < ar[None, :]
    mergeable = ((shared == 2) & upper & used[:, :, None]
                 & used[:, None, :])
    has_target = mergeable.any(dim=1)                          # (N, Mb)
    a_sel = _first_true(mergeable, 1)                          # (N, Mb)
    do_merge = has_target & ~has_target.gather(1, a_sel)
    T = (ar[None, :, None] == a_sel[:, None, :]) & do_merge[:, None, :]
    hasb = T.any(dim=2)                                        # (N, Ma)
    first_b = _first_true(T, 2)                                # (N, Ma)
    # a target absorbs its one mergee with an elementwise max
    idx = first_b[:, :, None, None].expand_as(subset)
    mergee = subset.gather(1, idx)
    subset = torch.where(hasb[:, :, None, None],
                         torch.maximum(subset, mergee), subset)
    consumed = (torch.zeros((n, M), dtype=torch.int32, device=used.device)
                .scatter_add(1, first_b, hasb.int()) > 0)
    subset = torch.where(consumed[:, :, None, None],
                         torch.full_like(subset, -1.0), subset)
    return subset, used & ~consumed


def _set_joint(subset, where, j, vals):
    """Rows `where` (N, M) of joint j take the 6 values `vals` (N, M, 6)."""
    subset[:, :, j] = torch.where(where[..., None], vals, subset[:, :, j])


def group_skeletons(packed_limbs: torch.Tensor, skeleton: Sequence,
                    cfg: DecoderConfig, n_keypoints: int = 17,
                    capacity: int = 64):
    """(N, L, K, 13) candidate limbs -> poses (N, max_poses, J, 6),
    scores (N, max_poses), counts (N,)."""
    x = packed_limbs.float()
    n, L, K, _ = x.shape
    J, M = n_keypoints, capacity
    dev = x.device
    subset = torch.full((n, M, J, 6), -1.0, device=dev)
    used = torch.zeros((n, M), dtype=torch.bool, device=dev)
    ark = torch.arange(K, device=dev)
    ninf = torch.tensor(float('-inf'), device=dev)

    for l, (jf, jt) in enumerate(skeleton):
        c = x[:, l]                                            # (N, K, 13)
        x1, y1, v1 = c[..., 0], c[..., 1], c[..., 2]
        x2, y2, v2 = c[..., 3], c[..., 4], c[..., 5]
        ind1, ind2 = c[..., 6], c[..., 7]
        delta, score = c[..., 8], c[..., 10]
        scale1, scale2 = c[..., 11], c[..., 12]

        if cfg.use_scale:
            lim = torch.maximum(torch.full_like(scale2, cfg.dist_max), scale2)
        else:
            lim = torch.full_like(scale2, cfg.dist_max)
        valid = (delta < lim) & (x1 > 0) & (y1 > 0) & (x2 > 0) & (y2 > 0)
        # dedup per end keypoint: highest limb score, ties to lowest index
        same = ind2[:, :, None] == ind2[:, None, :]
        better = ((score[:, None, :] > score[:, :, None])
                  | ((score[:, None, :] == score[:, :, None])
                     & (ark[None, :] < ark[:, None])))
        beaten = (valid[:, None, :] & same & better).any(dim=2)
        keep = valid & ~beaten

        jid_f, jid_t = subset[:, :, jf, COL_IND], subset[:, :, jt, COL_IND]
        row_gate = used[:, :, None] & keep[:, None, :]
        m1 = (jid_f[:, :, None] == ind1[:, None, :]) & row_gate
        m2 = (jid_t[:, :, None] == ind2[:, None, :]) & row_gate
        mask_sum = m1.int() + m2.int()                         # (N, M, K)
        sc_f = subset[:, :, jf, COL_LSC]
        sc_t = subset[:, :, jt, COL_LSC]
        s = score[:, None, :]
        replace = (s > sc_t[:, :, None]) | (s > sc_f[:, :, None])

        # redundant limb inside one skeleton: refresh limb scores
        upd2 = (mask_sum == 2) & replace
        best2 = torch.where(upd2, s, ninf).amax(dim=2)       # NaN propagates
        have2 = upd2.any(dim=2)
        for col in (jf, jt):
            old = subset[:, :, col, COL_LSC]
            subset[:, :, col, COL_LSC] = torch.where(
                have2, torch.maximum(old, best2), old)

        # extend skeletons sharing exactly one joint
        cand = (mask_sum == 1) & replace
        have1 = cand.any(dim=2)
        k_sel = _nan_argmax(torch.where(cand, s, ninf))        # (N, M)
        g = lambda v: v.gather(1, k_sel)
        sel_score = g(score)
        for col, fields in ((jf, (x1, y1, v1, scale1, ind1)),
                            (jt, (x2, y2, v2, scale2, ind2))):
            xv, yv, vv, sv, iv = (g(f) for f in fields)
            lsc = torch.maximum(subset[:, :, col, COL_LSC], sel_score)
            _set_joint(subset, have1, col,
                       torch.stack([xv, yv, vv, sv, lsc, iv], dim=-1))

        subset, used = _merge_pass(subset, used)

        # new skeletons from unmatched kept conns, onto free rows in order
        untouched = (mask_sum == 0).all(dim=1)                 # (N, K)
        new_k = keep & untouched
        new_rank = torch.cumsum(new_k.int(), dim=1) - 1
        free_rows = torch.argsort(used.int(), dim=1, stable=True)
        n_free = M - used.sum(dim=1, keepdim=True)
        ok = new_k & (new_rank < n_free)
        slot = free_rows.gather(1, new_rank.clamp(0, M - 1))   # (N, K)
        bi = torch.arange(n, device=dev)[:, None].expand(n, K)[ok]
        si = slot[ok]
        for col, fields in ((jf, (x1, y1, v1, scale1, ind1)),
                            (jt, (x2, y2, v2, scale2, ind2))):
            xv, yv, vv, sv, iv = fields
            subset[bi, si, col] = torch.stack(
                [xv, yv, vv, sv, score, iv], dim=-1)[ok]
        used[bi, si] = True

    for _ in range(cfg.settle_passes):
        subset, used = _merge_pass(subset, used)
    return _delete_sort(subset, used, cfg)


def _delete_sort(subset, used, cfg: DecoderConfig):
    """Score, filter, stable sort by score and compact to max_poses.

    A row's score sums its masked values serially over j, the order of the
    grouping kernel's final pass (`csrc/grouping.cu`), so the two scores
    are bit-equal and a cut at max_poses keeps the same one of two tied
    rows on both sides.

    The output always has max_poses rows, as the TPU kernel's (and the
    CUDA kernel's) has: where max_poses passes the capacity, the rows from
    the capacity on are zeros with score 0. The JAX package's XLA path
    returns min(capacity, max_poses) rows; the extra rows are never kept
    (`counts` <= capacity), so the records are the same."""
    vals = subset[..., cfg.sort_dim]                           # (N, M, J)
    pos = (vals > 0) & used[:, :, None]
    npos = pos.sum(dim=2)
    masked = vals * pos.float()
    total = torch.zeros_like(masked[..., 0])
    for j in range(masked.shape[2]):
        total = total + masked[..., j]
    score = torch.where(npos > 0, total / npos.clamp(min=1).float(),
                        torch.zeros_like(total))
    keep = used & (score >= cfg.person_thre)
    sort_key = torch.where(keep, score, torch.full_like(score, -1.0))
    order = torch.argsort(-sort_key, dim=1, stable=True)[:, :cfg.max_poses]
    out = subset.gather(1, order[:, :, None, None].expand(
        -1, -1, *subset.shape[2:]))
    out_keep = keep.gather(1, order)
    out = torch.where(out_keep[:, :, None, None], out, torch.zeros_like(out))
    out = torch.where(out == -1.0, torch.zeros_like(out), out)
    out_scores = torch.where(out_keep, score.gather(1, order),
                             torch.zeros_like(score[:, :cfg.max_poses]))
    pad = cfg.max_poses - out.shape[1]
    if pad > 0:
        out = torch.cat([out, out.new_zeros((out.shape[0], pad,
                                             *out.shape[2:]))], dim=1)
        out_scores = torch.cat(
            [out_scores, out_scores.new_zeros((out.shape[0], pad))], dim=1)
    return out, out_scores, keep.sum(dim=1).int()
