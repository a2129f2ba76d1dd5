"""Ground-truth target rendering (heatmaps, jitter offsets, guiding offsets,
scale maps) for a batch of padded person annotations.

Port of the JAX package's vectorized encoder (`ops/encoder.py`
`_encode_single`, its default): every (person, joint) and (person, limb)
renders on the full output grid at once, with the reference's window
bounds, grid-center alignment (`i*stride + stride/2 - 0.5`) and
nearest-wins overlap rules. Unlabeled cells keep the sentinels the losses
and the decoder expect: +inf offsets and NaN scales. Exact ties in a
nearest-wins contest go to the first person; the scale map takes the scale
of the person behind the last improving limb from each joint.
`downscale_mask` brings the input-resolution miss mask to the output grid.
The JAX package's scan form of the encoder is not ported.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..config.defaults import EncoderConfig


class Targets(NamedTuple):
    """GT tensors at the output stride, channels last; `encode_targets`
    prepends the batch dimension."""
    hmp: torch.Tensor     # (Ho, Wo, J) Gaussian keypoint heatmaps
    bg: torch.Tensor      # (Ho, Wo, 1) background = 1 - max_j hmp
    jomp: torch.Tensor    # (Ho, Wo, 2) jitter offset to nearest keypoint (+inf bg)
    omp: torch.Tensor     # (Ho, Wo, 2L) guiding offsets, interleaved x/y (+inf bg)
    scmp: torch.Tensor    # (Ho, Wo, J) keypoint scale at from-joints (NaN bg)
    pscmp: torch.Tensor   # (Ho, Wo, 2L) instance scales (1.0 bg)


def _window_mask(ix, iy, jx, jy, stride, size):
    """Boolean fill window around joints (jx, jy of any batched shape),
    the reference's rounded half-open slices, against the (Ho, Wo) cell
    index grids `ix`, `iy`."""
    x_min = torch.clamp(torch.round(jx / stride - size / 2), min=0.0)
    x_max = torch.round(jx / stride + size / 2)
    y_min = torch.clamp(torch.round(jy / stride - size / 2), min=0.0)
    y_max = torch.round(jy / stride + size / 2)
    sh = jx.shape + (1, 1)
    return ((ix >= x_min.reshape(sh)) & (ix < x_max.reshape(sh)) &
            (iy >= y_min.reshape(sh)) & (iy < y_max.reshape(sh)))


def _grids(out_h, out_w, stride, device):
    """Cell centers in input pixels (gx (Wo,), gy (Ho,), xx2, yy2) and the
    cell index grids (ix2, iy2), all float32, the 2-D ones (Ho, Wo)."""
    s = float(stride)
    ax = torch.arange(out_w, dtype=torch.float32, device=device)
    ay = torch.arange(out_h, dtype=torch.float32, device=device)
    gx, gy = ax * s + (s / 2 - 0.5), ay * s + (s / 2 - 0.5)
    xx2 = gx[None, :].expand(out_h, out_w)
    yy2 = gy[:, None].expand(out_h, out_w)
    ix2 = ax[None, :].expand(out_h, out_w)
    iy2 = ay[:, None].expand(out_h, out_w)
    return gx, gy, xx2, yy2, ix2, iy2


def _encode_single(anns: torch.Tensor, sigmas: torch.Tensor,
                   skeleton: Sequence, out_h: int, out_w: int,
                   cfg: EncoderConfig) -> Targets:
    """Targets of one sample, `anns` (P, J, 4) [x, y, v, scale]."""
    P, J = anns.shape[:2]
    L = len(skeleton)
    s = float(cfg.stride)
    dev = anns.device
    inf = torch.tensor(float('inf'), device=dev)
    gx, gy, xx2, yy2, ix2, iy2 = _grids(out_h, out_w, cfg.stride, dev)

    double_sigma2 = 2.0 * cfg.sigma * cfg.sigma
    gaussian_size = 2 * int(np.ceil(
        np.sqrt(-double_sigma2 * np.log(cfg.gaussian_clip)) / cfg.stride))

    jf = torch.tensor([a for a, _ in skeleton], device=dev)
    jt = torch.tensor([b for _, b in skeleton], device=dev)
    sig_f = sigmas.to(device=dev, dtype=torch.float32)[jf]

    px, py, pv, ps = anns.unbind(-1)                             # (P, J)
    vis = pv > 0

    # Gaussian heatmaps: windowed, clipped, max over persons
    wmask = _window_mask(ix2, iy2, px, py, s, gaussian_size)     # (P, J, Ho, Wo)
    ex = torch.exp(-(gx[None, None, :] - px[..., None]) ** 2 / double_sigma2)
    ey = torch.exp(-(gy[None, None, :] - py[..., None]) ** 2 / double_sigma2)
    g = ey[..., :, None] * ex[..., None, :]
    g = torch.where(g < cfg.gaussian_clip, 0.0, g)
    g = torch.where(wmask & vis[..., None, None], g, 0.0)
    hmp = g.max(dim=0).values.permute(1, 2, 0)                   # (Ho, Wo, J)

    # jitter offsets: nearest keypoint of any (person, joint); first wins
    jmask = _window_mask(ix2, iy2, px, py, s, cfg.fill_jitter_size)
    dx = px[..., None, None] - xx2                               # (P, J, Ho, Wo)
    dy = py[..., None, None] - yy2
    norm = torch.sqrt(dx * dx + dy * dy)
    norm = torch.where(jmask & vis[..., None, None], norm, inf)
    jmin, jbest = norm.reshape(P * J, out_h, out_w).min(dim=0)

    def sel(v):
        return v.reshape(P * J, out_h, out_w).gather(0, jbest[None])[0]

    j_off = torch.where(torch.isfinite(jmin)[..., None],
                        torch.stack([sel(dx), sel(dy)], dim=-1), inf)

    # guiding offsets + scales: per-limb nearest-wins over persons
    fx, fy, fv, fs = px[:, jf], py[:, jf], pv[:, jf], ps[:, jf]  # (P, L)
    tx, ty, tv = px[:, jt], py[:, jt], pv[:, jt]
    lvis = (fv > 0) & (tv > 0)
    omask = _window_mask(ix2, iy2, fx, fy, s, cfg.fill_scale_size)
    odx = tx[..., None, None] - xx2                              # (P, L, Ho, Wo)
    ody = ty[..., None, None] - yy2
    onorm = torch.sqrt(odx * odx + ody * ody)
    onorm = torch.where(omask & lvis[..., None, None], onorm, inf)
    omin, owinner = onorm.min(dim=0)                             # (L, Ho, Wo)
    any_win = torch.isfinite(omin)

    def psel(v):
        return v.gather(0, owinner[None])[0]

    o_off = torch.where(any_win[..., None],
                        torch.stack([psel(odx), psel(ody)], dim=-1), inf)

    # keypoint-scale map: the person behind the last limb from joint j
    # whose nearest-wins contest it won (max over those limbs' winners)
    winner_or = torch.where(any_win, owinner, -1)                # (L, Ho, Wo)
    fr_mask = jf[:, None] == torch.arange(J, device=dev)[None, :]  # (L, J)
    q_j = torch.where(fr_mask[:, :, None, None], winner_or[:, None],
                      -1).max(dim=0).values                      # (J, Ho, Wo)
    joint_scale = torch.where(ps >= cfg.min_jscale, ps, float('nan'))
    scale_sel = joint_scale.t().gather(
        1, q_j.clamp(min=0).reshape(J, -1)).reshape(J, out_h, out_w)
    scmp = torch.where(q_j >= 0, scale_sel, float('nan')).permute(1, 2, 0)

    pscale_val = fs / sig_f[None, :]                             # (P, L)
    psc = pscale_val.t().gather(1, owinner.reshape(L, -1)).reshape(
        L, out_h, out_w)
    psc = torch.where(any_win, psc, 1.0)
    pscmp = psc.permute(1, 2, 0)[..., None].expand(out_h, out_w, L, 2)

    bg = 1.0 - hmp.max(dim=-1, keepdim=True).values
    omp = o_off.permute(1, 2, 0, 3).reshape(out_h, out_w, 2 * L)
    return Targets(hmp=hmp, bg=bg, jomp=j_off, omp=omp, scmp=scmp,
                   pscmp=pscmp.reshape(out_h, out_w, 2 * L))


def encode_targets(anns, sigmas, skeleton: Sequence, out_h: int, out_w: int,
                   cfg: EncoderConfig) -> Targets:
    """Render GT targets for a batch.

    anns: (N, P, J, 4) padded person annotations [x, y, v, keypoint_scale]
    in input pixels (v <= 0 marks missing keypoints and padding slots), a
    tensor on the device to render on or a numpy array (CPU). sigmas: (J,)
    OKS sigmas. skeleton: (from, to) joint pairs. out_h, out_w: the output
    grid (input size // stride). Returns Targets with a batch dimension."""
    anns = torch.as_tensor(anns, dtype=torch.float32)
    sigmas = torch.as_tensor(np.asarray(sigmas, np.float32))
    skeleton = tuple(map(tuple, skeleton))
    per = [_encode_single(a, sigmas, skeleton, out_h, out_w, cfg)
           for a in anns]
    return Targets(*(torch.stack(f) for f in zip(*per)))


def downscale_mask(mask_miss: torch.Tensor, cfg: EncoderConfig
                   ) -> torch.Tensor:
    """Input-resolution mask (N, H, W), float in [0, 1] or uint8 in
    [0, 255] -> bool (N, H // stride, W // stride, 1).

    Bicubic downscaling by the integer stride (half-pixel alignment, edge
    clamp) thresholded at `cfg.mask_miss_threshold`: every output cell
    taps the same 4 relative input positions, so it is a strided 4-tap
    cubic filter per axis, summed in tap order."""
    from .resize import _cubic_kernel
    x = mask_miss
    if x.dtype == torch.uint8:
        x = x.float() / 255.0
    s = cfg.stride
    base = int(np.floor((s - 1) / 2.0))
    frac = (s - 1) / 2.0 - base
    wts = _cubic_kernel(np.arange(-1, 3) - frac)
    for axis in (1, 2):
        n = x.shape[axis]
        n_out = n // s
        i0 = torch.arange(n_out, device=x.device) * s + base - 1
        acc = None
        for t, wt in enumerate(wts):
            term = x.index_select(axis, (i0 + t).clamp(0, n - 1)) * float(wt)
            acc = term if acc is None else acc + term
        x = acc
    return (x > cfg.mask_miss_threshold)[..., None]
