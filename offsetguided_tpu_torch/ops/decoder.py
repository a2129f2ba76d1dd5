"""Keypoint detection + guiding-offset limb collection, batched tensors.

Same functions and layouts as the JAX package's `ops/decoder.py`: maps are
NHWC, candidates are per-channel `(N, C, K)` peak sets (at full input
resolution on the upsampled paths, at stride resolution in
`collect_limbs`), and `pack_limbs` gives the reference's
`(N, L, K, 13)` layout
[x1, y1, v1, x2, y2, v2, ind1, ind2, len_delta, len_limb, limb_score,
scale1, scale2].
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config.defaults import DecoderConfig


class Limbs(NamedTuple):
    """All candidate limbs of a batch; every field is (N, L, K) or (N, L, K, 2)."""
    xy_f: torch.Tensor
    score_f: torch.Tensor
    xy_t: torch.Tensor
    score_t: torch.Tensor
    ind_f: torch.Tensor      # int64 global keypoint index (channel*H*W + flat)
    ind_t: torch.Tensor
    min_dist: torch.Tensor
    len_limb: torch.Tensor
    limb_score: torch.Tensor
    scale_f: torch.Tensor
    scale_t: torch.Tensor


def hmp_nms(heat: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Max-pool peak NMS on (N, H, W, C) with a zero border: non-peak
    responses become 0."""
    pad = (kernel - 1) // 2
    x = heat.permute(0, 3, 1, 2)
    hmax = F.max_pool2d(F.pad(x, (pad, pad, pad, pad)), kernel, stride=1)
    hmax = hmax.permute(0, 2, 3, 1)
    return torch.where(hmax == heat, heat, torch.zeros((), dtype=heat.dtype,
                                                       device=heat.device))


def stable_topk(vals: torch.Tensor, k: int):
    """Top-k over the last axis, value descending, ties to the lowest index
    (the order of `lax.top_k`; `torch.topk` promises no tie order)."""
    v, i = torch.sort(vals, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def topk_channel(scores: torch.Tensor, k: int):
    """Top-k responses per channel of (N, H, W, C): `(scores, flat_inds,
    ys, xs)`, each (N, C, K), flat indices row-major over H*W."""
    n, h, w, c = scores.shape
    flat = scores.permute(0, 3, 1, 2).reshape(n, c, h * w)
    vals, inds = stable_topk(flat, k)
    return vals, inds, inds // w, inds % w


def joint_dets(hmps: torch.Tensor, k: int, nms_kernel: int = 3):
    """NMS + top-k composition."""
    return topk_channel(hmp_nms(hmps, nms_kernel), k)


def topk_channel_blockreduce(scores: torch.Tensor, k: int):
    """Exact top-k over NMS output (N, H, W, C) through 2x2 block maxima
    (after a 3x3 NMS no two unequal peaks share a 2x2 block). The top-k of
    the block maxima goes through `ops/cuda/topk.py`: the kernel for a CUDA
    tensor, `stable_topk` for a CPU tensor.

    Returns `(scores, flat_inds, ys, xs)`, each (N, C, K); the position
    inside a block is the first (row-major) maximum."""
    from .cuda import topk as cuda_topk

    n, h, w, c = scores.shape
    hb, wb = h // 2, w // 2
    x = scores.permute(0, 3, 1, 2)                             # (N, C, H, W)
    bvals = F.max_pool2d(x, 2, stride=2)                       # (N, C, hb, wb)
    topv, topb = cuda_topk.topk(bvals.reshape(n * c, hb * wb), k)
    topv, topb = topv.reshape(n, c, k), topb.reshape(n, c, k)
    by, bx = topb // wb, topb % wb
    ys0, xs0 = by * 2, bx * 2
    flat = x.reshape(n, c, h * w)
    cands = torch.stack([flat.gather(2, (ys0 + dy) * w + xs0 + dx)
                         for dy in (0, 1) for dx in (0, 1)])
    local = torch.argmax(cands, dim=0)                         # first wins
    ys = ys0 + local // 2
    xs = xs0 + local % 2
    return topv, ys * w + xs, ys, xs


def _interp_weights(f: torch.Tensor, method: str) -> torch.Tensor:
    if method == 'bilinear':
        return torch.stack([1.0 - f, f], dim=-1)
    rel = torch.arange(-1, 3, dtype=f.dtype, device=f.device)
    ad = (rel - f[..., None]).abs()
    a = -0.75
    ad2 = ad * ad
    ad3 = ad * ad2
    near = (a + 2) * ad3 - (a + 3) * ad2 + 1.0
    far = a * ad3 - 5 * a * ad2 + 8 * a * ad - 4 * a
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    return torch.where(ad <= 1.0, near, torch.where(ad < 2.0, far, zero))


def sample_limb_maps(maps: torch.Tensor, channels, xs: torch.Tensor,
                     ys: torch.Tensor, stride: int,
                     method: str = 'bilinear') -> torch.Tensor:
    """`upsample2d(maps, stride, method)` read at full-resolution integer
    pixels, without making the upsampled map (the gather form).

    maps (N, h, w, C); channels None (all C), (L,) one channel per limb, or
    (L, V) a channel group per limb; xs, ys (N, L, K). Returns (N, L, K, V)
    (V = C for None, 1 for (L,)). A sample whose footprint touches any
    non-finite cell, even at zero weight, is +inf: the full upsample would
    have spread the sentinel."""
    if method not in ('bilinear', 'bicubic'):
        raise ValueError(method)
    n, h, w, C = maps.shape
    L, k = xs.shape[1], xs.shape[2]
    dev = maps.device
    cx = (xs.float() + 0.5) / stride - 0.5
    cy = (ys.float() + 0.5) / stride - 0.5
    x0, y0 = torch.floor(cx), torch.floor(cy)
    wx = _interp_weights(cx - x0, method)                      # (N, L, K, T)
    wy = _interp_weights(cy - y0, method)
    T = wx.shape[-1]
    rel = torch.arange(T, device=dev) - (1 if method == 'bicubic' else 0)
    xi = (x0.long()[..., None] + rel).clamp(0, w - 1)
    yi = (y0.long()[..., None] + rel).clamp(0, h - 1)
    pix = yi[..., :, None] * w + xi[..., None, :]              # (N, L, K, T, T)
    if channels is None:
        ch = torch.arange(C, device=dev)[None, :].expand(L, C)
    else:
        ch = torch.as_tensor(np.asarray(channels), device=dev).long()
        ch = ch[:, None] if ch.dim() == 1 else ch
    V = ch.shape[1]
    idx = pix[..., None] * C + ch[None, :, None, None, None, :]
    taps = maps.reshape(n, h * w * C).gather(1, idx.reshape(n, -1))
    taps = taps.reshape(n, L, k, T, T, V)
    wgt = (wy[..., :, None] * wx[..., None, :])[..., None]
    finite = torch.isfinite(taps)
    val = (wgt * torch.where(finite, taps, torch.zeros_like(taps))).sum(
        dim=(-3, -2))
    touched = (~finite).any(dim=-3).any(dim=-2)
    return torch.where(touched, torch.full_like(val, float('inf')), val)


def _collect_from_peaks(scores, ys, xs, h: int, w: int, offs4, jtypes_f,
                        jtypes_t, cfg: DecoderConfig, jomps4, scmps4,
                        stride: int) -> Limbs:
    """Limb pairing from per-channel peak sets (scores/ys/xs (N, C, K) at
    full input resolution h x w)."""
    n, C, k = scores.shape
    L = len(jtypes_f)
    dev = scores.device
    jf = torch.as_tensor(np.asarray(jtypes_f), device=dev).long()
    jt = torch.as_tensor(np.asarray(jtypes_t), device=dev).long()
    inds = ys * w + xs

    def channel_dets(jtypes):
        s = scores[:, jtypes]
        i = inds[:, jtypes]
        x, y = xs[:, jtypes], ys[:, jtypes]
        xy = torch.stack([x, y], dim=-1).float()
        xy = torch.where(s[..., None] < cfg.thre_hmp, xy - 100000.0, xy)
        return i, s, x, y, xy

    inds_f, scores_f, xs_f, ys_f, xys_f = channel_dets(jf)
    inds_t, scores_t, _, _, xys_t = channel_dets(jt)

    V = offs4.shape[-1] // L
    ch_pairs = (V * np.arange(L))[:, None] + np.arange(V)[None, :]
    off_f = sample_limb_maps(offs4, ch_pairs, xs_f, ys_f, stride, 'bilinear')

    if scmps4 is not None:
        scale_all = sample_limb_maps(scmps4, np.arange(C), xs, ys, stride,
                                     cfg.resize_mode)[..., 0]   # (N, C, K)
        scales_f, scales_t = scale_all[:, jf], scale_all[:, jt]
    else:
        scales_f = torch.full_like(scores_f, cfg.default_scale)
        scales_t = torch.full_like(scores_t, cfg.default_scale)

    if jomps4 is not None:
        jit_all = sample_limb_maps(jomps4, None, xs, ys, stride, 'bilinear')
        jitter_f, jitter_t = jit_all[:, jf], jit_all[:, jt]
    else:
        jitter_f = torch.zeros((n, L, k, 2), device=dev)
        jitter_t = torch.zeros((n, L, k, 2), device=dev)

    guid_t = xys_f.repeat(1, 1, 1, V // 2) + off_f              # (N, L, K, V)

    if cfg.guid_jitter_refine and jomps4 is not None:
        pairs = []
        for j in range(V // 2):
            g = guid_t[..., 2 * j:2 * j + 2]
            gx = g[..., 0].trunc().clamp(-2 ** 31, 2 ** 31 - 1).long()
            gy = g[..., 1].trunc().clamp(-2 ** 31, 2 ** 31 - 1).long()
            ok = ((gx >= 0) & (gx < w) & (gy >= 0) & (gy < h)
                  & torch.isfinite(g).all(dim=-1))
            jit = sample_limb_maps(jomps4, None, gx.clamp(0, w - 1),
                                   gy.clamp(0, h - 1), stride, 'bilinear')
            pairs.append(torch.where(ok[..., None], g + jit, g))
        guid_t = torch.cat(pairs, dim=-1)

    return _match_limbs(guid_t, (inds_f, scores_f, xys_f, scales_f, jitter_f),
                        (inds_t, scores_t, xys_t, scales_t, jitter_t), jf, jt,
                        h * w, cfg, jomps4 is not None)


def _match_limbs(guid_t, start, end, jf, jt, page: int, cfg: DecoderConfig,
                 has_jitter: bool) -> Limbs:
    """Pair each start candidate's regressed end point `guid_t` (N, L, K, V)
    with the nearest end candidate (|[g1;g2] - [t;t]| for V = 4) and score
    the limb. `start` / `end` are (inds, scores, xys, scales, jitter) per
    limb; `page` is the flat map size of the candidate indices."""
    inds_f, scores_f, xys_f, scales_f, jitter_f = start
    inds_t, scores_t, xys_t, scales_t, jitter_t = end
    n, L, k = scores_f.shape
    V = guid_t.shape[-1]
    diff = guid_t[:, :, :, None, :] - xys_t.repeat(1, 1, 1, V // 2)[:, :, None]
    dist2 = (diff * diff).sum(dim=-1)                           # (N, L, K, M)
    min_d2, min_ind = dist2.min(dim=-1)
    min_dist = torch.sqrt(min_d2)

    take = lambda v: v.gather(2, min_ind)
    matched_score_t = take(scores_t)
    matched_ind_t = take(inds_t)
    matched_scale_t = take(scales_t)
    idx2 = min_ind[..., None].expand(n, L, k, 2)
    matched_xys_t = xys_t.gather(2, idx2)
    matched_jitter_t = jitter_t.gather(2, idx2)

    gind_f = inds_f + jf[None, :, None] * page
    gind_t = matched_ind_t + jt[None, :, None] * page

    d = xys_f - matched_xys_t
    len_limb = torch.clamp(torch.sqrt((d * d).sum(dim=-1)), min=cfg.min_len)
    limb_score = scores_f * matched_score_t * torch.exp(-min_dist / len_limb)

    if cfg.use_jitter_offset and has_jitter:
        xys_f = xys_f + jitter_f
        matched_xys_t = matched_xys_t + matched_jitter_t

    return Limbs(xy_f=xys_f, score_f=scores_f, xy_t=matched_xys_t,
                 score_t=matched_score_t, ind_f=gind_f, ind_t=gind_t,
                 min_dist=min_dist, len_limb=len_limb, limb_score=limb_score,
                 scale_f=scales_f, scale_t=matched_scale_t)


def scored_offset(hmp: torch.Tensor, off: torch.Tensor, jtypes_f,
                  kernel_size: int = 3) -> torch.Tensor:
    """Heatmap-score-weighted local average of guiding offsets: `off`
    (N, H, W, V*L) averaged over a k x k window (zero border) with the
    start joint's heatmap response as the weight."""
    n, h, w, c2 = off.shape
    L = len(jtypes_f)
    score = hmp[..., list(np.asarray(jtypes_f))]                  # (N, H, W, L)
    somap = off.reshape(n, h, w, L, c2 // L) * score[..., None]   # (N,H,W,L,V)
    pad = (kernel_size - 1) // 2

    def box_sum(x):
        y = F.pad(x.reshape(n, h, w, -1).permute(0, 3, 1, 2),
                  (pad, pad, pad, pad))
        acc = None
        for dy in range(kernel_size):
            for dx in range(kernel_size):
                t = y[:, :, dy:dy + h, dx:dx + w]
                acc = t if acc is None else acc + t
        return acc.permute(0, 2, 3, 1).reshape(x.shape)

    mean_score = box_sum(score)                                   # (N, H, W, L)
    weighted = box_sum(somap) / (mean_score[..., None] + 1e-6)
    return weighted.reshape(n, h, w, c2)


def collect_limbs(hmps: torch.Tensor, offs: torch.Tensor, jtypes_f,
                  jtypes_t, cfg: DecoderConfig,
                  scmps: Optional[torch.Tensor] = None) -> Limbs:
    """Limb pairing with every map at one resolution (the stride-resolution
    decode; the caller adds the jitter offsets after mapping cells to
    pixels). Candidates per channel come from `ops/cuda/nms_topk.py` for a
    3x3 NMS (the fused kernel for a CUDA tensor, its plain version for a CPU
    tensor) and from `joint_dets` for any other window. `offs`
    (N, H, W, V*L) are in the maps' cell units."""
    n, h, w, c = hmps.shape
    L = len(jtypes_f)
    k = cfg.topk
    dev = hmps.device
    jf = torch.as_tensor(np.asarray(jtypes_f), device=dev).long()
    jt = torch.as_tensor(np.asarray(jtypes_t), device=dev).long()

    if cfg.nms_kernel == 3:
        from .cuda import nms_topk as cuda_nms
        bt = hmps.permute(0, 3, 1, 2).reshape(n * c, h, w)
        vals, flat = cuda_nms.nms_topk(bt, k)
        scores, inds = vals.reshape(n, c, k), flat.reshape(n, c, k)
        ys, xs = inds // w, inds % w
    else:
        scores, inds, ys, xs = joint_dets(hmps, k, cfg.nms_kernel)

    def channel_dets(jtypes):
        s = scores[:, jtypes]
        xy = torch.stack([xs[:, jtypes], ys[:, jtypes]], dim=-1).float()
        xy = torch.where(s[..., None] < cfg.thre_hmp, xy - 100000.0, xy)
        i = inds[:, jtypes]
        if scmps is None:
            scale = torch.full_like(s, cfg.default_scale)
        else:
            scale = scmps.permute(0, 3, 1, 2).reshape(n, c, h * w)[
                :, jtypes].gather(2, i)
        return i, s, xy, scale, torch.zeros((n, L, k, 2), device=dev)

    start, end = channel_dets(jf), channel_dets(jt)
    inds_f, _, xys_f = start[:3]
    V = offs.shape[-1] // L
    base = inds_f * (L * V) + (torch.arange(L, device=dev) * V)[None, :, None]
    idx = torch.stack([base + j for j in range(V)], dim=-1)
    off_f = offs.reshape(n, h * w * L * V).gather(
        1, idx.reshape(n, L * k * V)).reshape(n, L, k, V)
    guid_t = xys_f.repeat(1, 1, 1, V // 2) + off_f
    return _match_limbs(guid_t, start, end, jf, jt, h * w, cfg, False)


def collect_limbs_peak_sampled(hmp_up: torch.Tensor, offs4: torch.Tensor,
                               jtypes_f, jtypes_t, cfg: DecoderConfig,
                               jomps4: Optional[torch.Tensor] = None,
                               scmps4: Optional[torch.Tensor] = None,
                               stride: int = 4) -> Limbs:
    """Peaks of the upsampled heatmaps `hmp_up` (N, H, W, C) at full input
    resolution through NMS (`cfg.nms_kernel`) and the block-reduced exact
    top-k, then limb pairing; the auxiliary maps stay at stride resolution
    and are interpolated at the peaks only."""
    h, w = hmp_up.shape[1:3]
    scores, _, ys, xs = topk_channel_blockreduce(
        hmp_nms(hmp_up, cfg.nms_kernel), cfg.topk)
    return _collect_from_peaks(scores, ys, xs, h, w, offs4, jtypes_f,
                               jtypes_t, cfg, jomps4, scmps4, stride)


def collect_limbs_peak_fused(hmps: torch.Tensor, offs4: torch.Tensor,
                             jtypes_f, jtypes_t, cfg: DecoderConfig,
                             jomps4: Optional[torch.Tensor] = None,
                             scmps4: Optional[torch.Tensor] = None) -> Limbs:
    """Peaks of the x4 upsampled heatmaps through the peaks kernel (its
    plain version on the CPU), then limb pairing. `hmps` are stride-4
    (N, h, w, C); the auxiliary maps stay at stride resolution and are
    interpolated at the peaks only."""
    from .cuda.peaks import FACTOR as stride, peaks_topk

    n, h, w, c = hmps.shape
    k = cfg.topk
    bt = hmps.permute(0, 3, 1, 2).reshape(n * c, h, w)
    vals, ys, xs = peaks_topk(bt, k, method=cfg.resize_mode)
    return _collect_from_peaks(
        vals.reshape(n, c, k), ys.reshape(n, c, k), xs.reshape(n, c, k),
        h * stride, w * stride, offs4, jtypes_f, jtypes_t, cfg, jomps4,
        scmps4, stride)


def pack_limbs(limbs: Limbs) -> torch.Tensor:
    """Pack to the reference's (N, L, K, 13) column layout."""
    cols = [limbs.xy_f[..., 0], limbs.xy_f[..., 1], limbs.score_f,
            limbs.xy_t[..., 0], limbs.xy_t[..., 1], limbs.score_t,
            limbs.ind_f.float(), limbs.ind_t.float(),
            limbs.min_dist, limbs.len_limb, limbs.limb_score,
            limbs.scale_f, limbs.scale_t]
    return torch.stack(cols, dim=-1)


def unpack_limbs(packed) -> Limbs:
    """Inverse of `pack_limbs` (takes a tensor or a numpy array); the
    keypoint indices come back as int64."""
    p = torch.as_tensor(packed)
    return Limbs(
        xy_f=p[..., 0:2], score_f=p[..., 2],
        xy_t=p[..., 3:5], score_t=p[..., 5],
        ind_f=p[..., 6].long(), ind_t=p[..., 7].long(),
        min_dist=p[..., 8], len_limb=p[..., 9], limb_score=p[..., 10],
        scale_f=p[..., 11], scale_t=p[..., 12])
