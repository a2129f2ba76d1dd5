"""The plain decode: peaks, limb collection, grouping, flip merge.

A frozen copy of the port's plain decode (`ops/resize.py`,
`ops/decoder.py`, `ops/grouping.py`, `decoder/pipeline.py`) as its CPU
path runs it, with every CUDA kernel replaced by the plain PyTorch
composition the kernel is held to: the fused peaks kernel by the bicubic
x4 upsample + 3x3 NMS + block-reduced stable top-k, the block top-k kernel
by `stable_topk`, the NMS + top-k kernel by `joint_dets`, the grouping
kernel by `group_skeletons` below. It imports nothing of the port, so a
change to the port's decode cannot move the benchmark's reference.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

PEAKS_FACTOR = 4        # the upsampled decode's factor (the maps' stride)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Decoding / grouping settings, the fields and defaults of the port's
    `config/defaults.py::DecoderConfig`."""
    stride: int = 4
    topk: int = 48
    thre_hmp: float = 0.06
    min_len: float = 0.5
    dist_max: float = 20.0
    use_scale: bool = True
    use_jitter_offset: bool = True
    default_scale: float = 4.0
    person_thre: float = 0.06
    sort_dim: int = 2
    resize_mode: str = 'bicubic'
    feat_stage: int = -1
    nms_kernel: int = 3
    max_poses: int = 40
    capacity: int = 64
    upsampled_decode: bool = True
    scored_offset: bool = False
    cat_flip_offs: bool = False
    guid_jitter_refine: bool = False
    settle_passes: int = 2


def _mirror(name: str) -> str:
    if name.startswith('left'):
        return name.replace('left', 'right', 1)
    if name.startswith('right'):
        return name.replace('right', 'left', 1)
    return name


@dataclasses.dataclass(frozen=True)
class Skeleton:
    """Keypoint names and guiding-offset limbs; the flip tables follow
    from the names' left / right prefixes."""
    keypoints: tuple
    skeleton: tuple

    @property
    def n_keypoints(self) -> int:
        return len(self.keypoints)

    def heatmap_flip_indices(self) -> np.ndarray:
        return np.asarray([self.keypoints.index(_mirror(n))
                           for n in self.keypoints], dtype=np.int32)

    def offset_flip_indices(self):
        """(flip_indices, reserve_indices): the limb channel of the flipped
        prediction for each limb, and the limbs whose mirror runs the other
        way (their flipped offsets are not averaged)."""
        names = [(self.keypoints[a], self.keypoints[b])
                 for a, b in self.skeleton]
        flipped = [(_mirror(a), _mirror(b)) for a, b in names]
        flip = list(range(len(self.skeleton)))
        reserve = []
        for i, (a, b) in enumerate(names):
            if (a, b) in flipped:
                flip[i] = flipped.index((a, b))
            if (b, a) in flipped:
                flip[i] = flipped.index((b, a))
                reserve.append(i)
        return (np.asarray(flip, dtype=np.int32),
                np.asarray(reserve, dtype=np.int32))


def _cubic_kernel(d: np.ndarray, a: float = -0.75) -> np.ndarray:
    d = np.abs(d)
    return np.where(
        d <= 1.0,
        (a + 2.0) * d ** 3 - (a + 3.0) * d ** 2 + 1.0,
        np.where(d < 2.0,
                 a * d ** 3 - 5.0 * a * d ** 2 + 8.0 * a * d - 4.0 * a, 0.0))


@functools.lru_cache(maxsize=32)
def phase_table(factor: int, method: str) -> tuple[np.ndarray, np.ndarray]:
    """Per-phase `(offsets (n_taps,), weights (factor, n_taps))`: tap
    positions relative to the source cell, and each phase's weights."""
    phases = (np.arange(factor) + 0.5) / factor - 0.5
    base = np.floor(phases).astype(np.int64)
    frac = phases - base
    if method == 'bicubic':
        rel = np.arange(-1, 3)
        weights = _cubic_kernel(rel[None, :] - frac[:, None])
    elif method == 'bilinear':
        rel = np.arange(0, 2)
        weights = np.maximum(0.0, 1.0 - np.abs(rel[None, :] - frac[:, None]))
    elif method == 'nearest':
        rel = np.arange(0, 1)
        weights = np.ones((factor, 1))
        base = np.floor(phases + 0.5).astype(np.int64)
    else:
        raise ValueError(f'unknown resize method: {method}')
    min_off = int(base.min() + rel.min())
    max_off = int(base.max() + rel.max())
    offsets = np.arange(min_off, max_off + 1)
    full = np.zeros((factor, offsets.size))
    for p in range(factor):
        for t, r in enumerate(rel):
            full[p, base[p] + r - min_off] += weights[p, t]
    return offsets, full


def phase_taps(factor: int, method: str):
    """[phase] -> [(offset, float32 weight)] without the zero taps."""
    offsets, weights = phase_table(factor, method)
    return [[(int(off), float(np.float32(weights[p, t])))
             for t, off in enumerate(offsets) if float(weights[p, t]) != 0.0]
            for p in range(factor)]


def upsample_axis(x: torch.Tensor, axis: int, factor: int,
                  method: str) -> torch.Tensor:
    """Upsample one axis by an integer factor with half-pixel alignment."""
    if factor == 1:
        return x
    axis = axis % x.ndim
    n = x.shape[axis]
    idx = torch.arange(n, device=x.device)
    parts = []
    for taps in phase_taps(factor, method):
        acc = None
        for off, wt in taps:
            src = x.index_select(axis, (idx + off).clamp(0, n - 1))
            term = src * torch.tensor(wt, dtype=x.dtype, device=x.device)
            acc = term if acc is None else acc + term
        parts.append(acc)
    stacked = torch.stack(parts, dim=axis + 1)
    shape = list(x.shape)
    shape[axis] = n * factor
    return stacked.reshape(shape)


def upsample2d(x: torch.Tensor, factor: int, method: str = 'bicubic',
               h_axis: int = 1, w_axis: int = 2) -> torch.Tensor:
    """Upsample two spatial axes (default NHWC) by `factor`."""
    x = upsample_axis(x, h_axis, factor, method)
    return upsample_axis(x, w_axis, factor, method)


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
    the block maxima is `stable_topk`.

    Returns `(scores, flat_inds, ys, xs)`, each (N, C, K); the position
    inside a block is the first (row-major) maximum."""
    n, h, w, c = scores.shape
    hb, wb = h // 2, w // 2
    x = scores.permute(0, 3, 1, 2)                             # (N, C, H, W)
    bvals = F.max_pool2d(x, 2, stride=2)                       # (N, C, hb, wb)
    topv, topb = stable_topk(bvals.reshape(n * c, hb * wb), k)
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
    pixels). Candidates per channel come from `joint_dets`. `offs`
    (N, H, W, V*L) are in the maps' cell units."""
    n, h, w, c = hmps.shape
    L = len(jtypes_f)
    k = cfg.topk
    dev = hmps.device
    jf = torch.as_tensor(np.asarray(jtypes_f), device=dev).long()
    jt = torch.as_tensor(np.asarray(jtypes_t), device=dev).long()

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
    stride = PEAKS_FACTOR
    n, h, w, c = hmps.shape
    k = cfg.topk
    bt = hmps.permute(0, 3, 1, 2).reshape(n * c, h, w)
    up = upsample2d(bt.float()[..., None], stride, cfg.resize_mode)
    vals, _, ys, xs = topk_channel_blockreduce(hmp_nms(up), k)
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


@dataclasses.dataclass(frozen=True)
class PostProcessor:
    skeleton: Skeleton
    cfg: DecoderConfig

    def __post_init__(self):
        if self.cfg.stride != PEAKS_FACTOR:
            raise NotImplementedError(
                f'the peaks kernel upsamples by {PEAKS_FACTOR}, the maps '
                f'have stride {self.cfg.stride}')
        jf, jt = np.asarray(self.skeleton.skeleton, dtype=np.int64).T
        limb_flip, reserve = self.skeleton.offset_flip_indices()
        object.__setattr__(self, '_jf', jf)
        object.__setattr__(self, '_jt', jt)
        object.__setattr__(self, '_kp_flip',
                           self.skeleton.heatmap_flip_indices().tolist())
        object.__setattr__(self, '_limb_flip', limb_flip.tolist())
        object.__setattr__(self, '_reserve', reserve.tolist())

    def select_stage(self, preds: Dict[str, List]) -> Dict[str, Optional[torch.Tensor]]:
        """Pick one stack's maps."""
        stage = self.cfg.feat_stage
        return {k: preds[k][stage] for k in ('hmp', 'jomp', 'omp', 'scmp')}

    def flip_merge(self, maps: Dict[str, Optional[torch.Tensor]]):
        """Merge a flip-test doubled batch [originals; W-flipped inputs]:
        flipped maps are un-flipped and channel-permuted, offsets also
        negate x and permute limbs; direction-reversed limbs (`reserve`)
        keep the original prediction only."""
        hmp = maps['hmp']
        n2 = hmp.shape[0]
        n = n2 // 2
        kp_flip = self._kp_flip

        def unflip(x):
            return torch.flip(x[n:], dims=(2,))

        out = {'hmp': (hmp[:n] + unflip(hmp)[..., kp_flip]) / 2}
        if maps['jomp'] is not None:
            fj = unflip(maps['jomp']).clone()
            fj[..., 0] *= -1.0
            out['jomp'] = (maps['jomp'][:n] + fj) / 2
        else:
            out['jomp'] = None

        off = maps['omp']
        h, w = off.shape[1:3]
        L = off.shape[-1] // 2
        off5 = off.reshape(n2, h, w, L, 2)
        orig = off5[:n]
        flip = torch.flip(off5[n:], dims=(2,)).clone()
        flip[..., 0] *= -1.0
        flip = flip[..., self._limb_flip, :]
        r = self._reserve
        if self.cfg.cat_flip_offs:
            cat = torch.cat([orig, flip], dim=-1)              # (N, h, w, L, 4)
            if r:
                cat[..., r, 2:4] = orig[..., r, :]
            out['omp'] = cat.reshape(n, h, w, 4 * L)
        else:
            merged = (orig + flip) / 2
            if r:
                merged[..., r, :] = orig[..., r, :]
            out['omp'] = merged.reshape(n, h, w, 2 * L)

        if maps['scmp'] is not None:
            fs = unflip(maps['scmp'])[..., kp_flip]
            out['scmp'] = (maps['scmp'][:n] + fs) / 2
        else:
            out['scmp'] = None
        return out

    def decode_packed_limbs(self, preds, flip_test: bool = False):
        """preds -> (N, L, K, 13) packed candidate limbs."""
        maps = self.select_stage(preds)
        if flip_test:
            maps = self.flip_merge(maps)
        cfg = self.cfg
        s = cfg.stride
        hmp, omp, scmp = maps['hmp'], maps['omp'], maps['scmp']
        jomp = maps['jomp'] if cfg.use_jitter_offset else None
        if cfg.scored_offset:
            omp = scored_offset(hmp, omp, self._jf, kernel_size=3)
        if cfg.upsampled_decode:
            if hmp.shape[1] == hmp.shape[2] and cfg.nms_kernel == 3:
                limbs = collect_limbs_peak_fused(
                    hmp, omp, self._jf, self._jt, cfg, jomps4=jomp,
                    scmps4=scmp)
            else:
                limbs = collect_limbs_peak_sampled(
                    upsample2d(hmp, s, cfg.resize_mode), omp, self._jf,
                    self._jt, cfg, jomps4=jomp, scmps4=scmp, stride=s)
            return pack_limbs(limbs)

        limbs = collect_limbs(hmp, omp / float(s), self._jf,
                                      self._jt, cfg, scmps=scmp)
        packed = pack_limbs(limbs)
        # cell -> input pixel (x * s + s/2 - 0.5) for on-image candidates;
        # off-image sentinels stay far negative; lengths scale by s
        xy_cols = [0, 1, 3, 4]
        coords = packed[..., xy_cols]
        packed[..., xy_cols] = torch.where(coords > -1000.0,
                                           coords * s + (s / 2 - 0.5), coords)
        packed[..., 8:10] *= float(s)
        if jomp is not None:
            packed = self._apply_jitter_lowres(packed, jomp, limbs)
        return packed

    def _apply_jitter_lowres(self, packed, jomp, limbs):
        """Add the jitter offsets (input-pixel units) at the stride-resolution
        candidates' cells."""
        n, h, w, _ = jomp.shape
        L, k = limbs.ind_f.shape[1:]
        page = h * w
        flat = jomp.reshape(n, page, 2)

        def gather(ind):                       # ind (N, L, K) global index
            idx = (ind % page).reshape(n, L * k, 1).expand(n, L * k, 2)
            return flat.gather(1, idx).reshape(n, L, k, 2)

        packed[..., 0:2] += gather(limbs.ind_f)
        packed[..., 3:5] += gather(limbs.ind_t)
        return packed

    def decode_body(self, preds, flip_test: bool = False):
        """preds (PoseNet output) -> (poses, scores, counts); poses are
        (N, max_poses, J, 6) in network-input pixel coordinates."""
        packed = self.decode_packed_limbs(preds, flip_test)
        skeleton = tuple(zip(self._jf.tolist(), self._jt.tolist()))
        return group_skeletons(
            packed, skeleton, self.cfg, n_keypoints=self.skeleton.n_keypoints,
            capacity=self.cfg.capacity)
