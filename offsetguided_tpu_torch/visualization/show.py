"""Pose and feature-map painting into raster images, without matplotlib.

Port of the JAX package's `visualization/show.py` with its public names:
image canvases, the skeleton painter (solid limbs where both keypoints
pass `highlight_threshold`, dashed otherwise; markers; an optional box
with the score), heatmap overlays, guiding-offset arrows, the field
renderers (quiver, margins, arrows, boxes, circles), crowd regions and the
white wash. The JAX package draws on matplotlib axes; here a `Canvas`
holds an (H, W, 3) uint8 image at the picture's own resolution, the
shapes are rasterized by `data/draw.py`, and `image_canvas` / `canvas`
write PNG (or JPEG) through `data/codec.py::imwrite`. Every renderer
takes the canvas where the JAX package takes the axes.

Colours: matplotlib's `tab20` (one per person, by index mod 20) and `jet`
(heatmaps and field intensities; it stands in for the `viridis_r` of the
JAX package's `boxes` / `circles`, whose table the port does not carry)
are constants here; named colours are the handful the JAX package uses.
Scores print with a 3x5 digit font.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np

from ..config.defaults import SkeletonConfig
from ..data import codec, draw

# matplotlib's tab20 (its float values are these bytes / 255)
TAB20 = np.array([
    [31, 119, 180], [174, 199, 232], [255, 127, 14], [255, 187, 120],
    [44, 160, 44], [152, 223, 138], [214, 39, 40], [255, 152, 150],
    [148, 103, 189], [197, 176, 213], [140, 86, 75], [196, 156, 148],
    [227, 119, 194], [247, 182, 210], [127, 127, 127], [199, 199, 199],
    [188, 189, 34], [219, 219, 141], [23, 190, 207], [158, 218, 229]],
    np.uint8)

# matplotlib's jet: piecewise-linear (x, value) segments per channel
_JET_SEGMENTS = (
    ((0.0, 0.0), (0.35, 0.0), (0.66, 1.0), (0.89, 1.0), (1.0, 0.5)),
    ((0.0, 0.0), (0.125, 0.0), (0.375, 1.0), (0.64, 1.0), (0.91, 0.0),
     (1.0, 0.0)),
    ((0.0, 0.5), (0.11, 1.0), (0.34, 1.0), (0.65, 0.0), (1.0, 0.0)),
)


def _jet_table(n: int = 256) -> np.ndarray:
    """(n, 3) float64 in [0, 1]: matplotlib's lookup table of `jet` (its
    segments sampled at linspace(0, 1, n))."""
    x = np.linspace(0.0, 1.0, n)
    return np.stack([np.interp(x, *np.array(seg).T)
                     for seg in _JET_SEGMENTS], axis=1)


JET = _jet_table()

COLORS = {'white': (255, 255, 255), 'black': (0, 0, 0),
          'lime': (0, 255, 0), 'cyan': (0, 255, 255),
          'orange': (255, 165, 0), 'red': (255, 0, 0)}


def _rgb(color) -> np.ndarray:
    """A colour name, RGB(A) floats in [0, 1] or uint8 RGB -> 3 floats in
    0..255."""
    if isinstance(color, str):
        return np.asarray(COLORS[color], np.float64)
    c = np.asarray(color)
    if c.dtype == np.uint8:
        return c[:3].astype(np.float64)
    return c[:3].astype(np.float64) * 255.0


def colormap(values, cmap: str = 'jet', clim=None) -> np.ndarray:
    """Values -> (..., 3) uint8 through `jet` (or `jet_r`), normalized to
    `clim` (default: the values' min and max), as matplotlib maps them
    (its 256 bins, the top value in the last)."""
    if cmap not in ('jet', 'jet_r'):
        raise ValueError(f'colormap {cmap!r}: the port carries jet and jet_r')
    v = np.asarray(values, np.float64)
    lo, hi = (np.nanmin(v), np.nanmax(v)) if clim is None else clim
    t = (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)
    idx = np.clip((t * len(JET)).astype(np.int64), 0, len(JET) - 1)
    if cmap == 'jet_r':
        idx = len(JET) - 1 - idx
    return np.rint(JET[idx] * 255.0).astype(np.uint8)


class Canvas:
    """An (H, W, 3) uint8 picture the renderers draw into (a copy of the
    image it starts from)."""

    def __init__(self, image: np.ndarray):
        image = np.asarray(image)
        if image.ndim == 2:
            image = np.repeat(image[..., None], 3, axis=-1)
        if image.dtype != np.uint8:      # floats as matplotlib shows them
            image = np.rint(np.clip(image[..., :3], 0.0, 1.0) * 255.0)
        self.pixels = np.array(image[..., :3], np.uint8, order='C')

    @property
    def shape(self):
        return self.pixels.shape[:2]

    def show_image(self, image: np.ndarray, alpha: float = 1.0) -> None:
        """Blend `image` (any size: nearest-neighbour to the canvas, as
        an image extent stretched over it) over the canvas."""
        src = Canvas(image).pixels
        h, w = self.shape
        ys = (np.arange(h) * src.shape[0]) // h
        xs = (np.arange(w) * src.shape[1]) // w
        src = src[ys[:, None], xs[None, :]].astype(np.float64)
        out = self.pixels * (1.0 - alpha) + src * alpha
        self.pixels[:] = np.rint(out).astype(np.uint8)


def _write(c: Canvas, fig_file: Optional[str]) -> None:
    if fig_file:
        codec.imwrite(fig_file, c.pixels)


@contextlib.contextmanager
def canvas(fig_file: Optional[str] = None, height: int = 480,
           width: int = 640):
    """A white canvas of (height, width), written to `fig_file` at exit."""
    c = Canvas(np.full((height, width, 3), 255, np.uint8))
    yield c
    _write(c, fig_file)


@contextlib.contextmanager
def image_canvas(image: np.ndarray, fig_file: Optional[str] = None):
    """A canvas holding `image` (uint8, or floats in [0, 1], clipped),
    written to `fig_file` at exit."""
    c = Canvas(image)
    yield c
    _write(c, fig_file)


class KeypointPainter:
    """Multi-person skeletons: person i in `TAB20[i % 20]`; a limb is
    solid where both its keypoints' scores pass `highlight_threshold`,
    dashed otherwise; markers of radius `markersize` pixels; with
    `show_box`, the box of the visible keypoints and the person's score."""

    def __init__(self, *, skeleton_cfg: SkeletonConfig = SkeletonConfig(),
                 markersize: float = 3.0, linewidth: float = 2.0,
                 highlight_threshold: float = 0.5, show_box: bool = False):
        self.cfg = skeleton_cfg
        self.markersize = markersize
        self.linewidth = linewidth
        self.thr = highlight_threshold
        self.show_box = show_box

    def keypoints(self, ax: Canvas, poses: np.ndarray,
                  scores: Optional[Sequence[float]] = None, skeleton=None):
        skeleton = skeleton or self.cfg.skeleton
        img = ax.pixels
        for pi, pose in enumerate(np.asarray(poses)):
            color = TAB20[pi % 20]
            xy, vs = pose[:, :2], pose[:, 2]
            for a, b in skeleton:
                if vs[a] > 0 and vs[b] > 0:
                    solid = vs[a] > self.thr and vs[b] > self.thr
                    draw.segments(img, xy[a], xy[b], color, self.linewidth,
                                  dash=None if solid else (6.0, 4.0))
            vis = vs > 0
            draw.disks(img, xy[vis], self.markersize, color)
            if self.show_box and vis.any():
                x0, y0 = xy[vis].min(0)
                x1, y1 = xy[vis].max(0)
                corners = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
                draw.segments(img, corners, np.roll(corners, -1, 0), color)
                if scores is not None:
                    draw.text(img, x0, y0 - 12, f'{scores[pi]:.2f}', color)


def heatmap_overlay(ax: Canvas, image: np.ndarray, hmp: np.ndarray,
                    channel: Optional[int] = None, alpha: float = 0.5):
    """Show a heatmap channel (or the max over channels), through `jet`
    over its own range, at `alpha` over `image`, both stretched over the
    canvas."""
    h = hmp[..., channel] if channel is not None else hmp.max(-1)
    ax.show_image(image)
    ax.show_image(colormap(h), alpha)


def _arrows(img: np.ndarray, x, y, u, v, colors, width: float = 1.0,
            head: float = 3.0) -> None:
    """Arrows from (x, y) by (u, v), heads `head` pixels long at 30
    degrees; `colors` is one colour or one row (M, 3) an arrow, drawn in
    order of each colour's first arrow (callers sort weakest first)."""
    p = np.stack([x, y], axis=-1).reshape(-1, 2).astype(np.float64)
    d = np.stack([u, v], axis=-1).reshape(-1, 2).astype(np.float64)
    q = p + d
    unit = d / np.maximum(np.hypot(d[:, 0], d[:, 1]), 1e-9)[:, None]
    c, s = np.cos(np.radians(150.0)), np.sin(np.radians(150.0))
    heads = [q + head * np.stack([unit[:, 0] * c - unit[:, 1] * si,
                                  unit[:, 0] * si + unit[:, 1] * c], -1)
             for si in (s, -s)]
    colors = np.asarray(colors)
    if colors.ndim == 1:
        colors = np.broadcast_to(colors, (len(p), colors.shape[0]))
    if len(p) == 0:
        return
    uniq, first, inv = np.unique(colors, axis=0, return_index=True,
                                 return_inverse=True)
    for g in np.argsort(first):
        sel = inv.reshape(-1) == g
        for a, b in ((p, q), (q, heads[0]), (q, heads[1])):
            draw.segments(img, a[sel], b[sel], uniq[g], width)


def draw_limb_offset(ax: Canvas, omp: np.ndarray, limb: int, stride: int = 4,
                     step: int = 2, threshold: float = 1e3):
    """Arrows of one limb's guiding offsets (finite cells only), from
    each cell's center in input pixels."""
    off = omp[..., 2 * limb:2 * limb + 2]
    hh, ww = off.shape[:2]
    ys, xs = np.mgrid[0:hh:step, 0:ww:step]
    u = off[::step, ::step, 0]
    v = off[::step, ::step, 1]
    finite = np.isfinite(u) & np.isfinite(v) & (np.abs(u) < threshold)
    _arrows(ax.pixels, xs[finite] * stride + stride / 2 - 0.5,
            ys[finite] * stride + stride / 2 - 0.5, u[finite], v[finite],
            _rgb('cyan'))


def _field_grid(shape, intensity_field, step: int, threshold: float):
    """Subsampled grid coordinates, intensities and keep mask shared by
    the field renderers."""
    hh, ww = shape[:2]
    ys, xs = np.mgrid[0:hh:step, 0:ww:step]
    if intensity_field is not None:
        c = np.asarray(intensity_field)[::step, ::step]
        keep = c >= threshold
    else:
        c = np.ones(xs.shape, np.float32)
        keep = np.ones(xs.shape, bool)
    return xs[keep], ys[keep], c[keep], keep


def quiver(ax: Canvas, vector_field: np.ndarray,
           intensity_field: Optional[np.ndarray] = None, *, step: int = 1,
           threshold: float = 0.5, xy_scale: float = 1.0,
           uv_is_offset: bool = False,
           reg_uncertainty: Optional[np.ndarray] = None, cmap: str = 'jet',
           clim=None) -> int:
    """Intensity-coloured arrow field. vector_field (H, W, 2);
    intensity_field (H, W) gates cells below `threshold`; arrows draw
    weakest first. With `uv_is_offset` the field holds absolute targets
    and the grid position is subtracted. reg_uncertainty (H, W) adds an
    orange ring of radius r/2 at each arrow tip. Returns the arrow
    count."""
    vf = np.asarray(vector_field)
    xs, ys, cs, keep = _field_grid(vf.shape, intensity_field, step,
                                   threshold)
    u = vf[::step, ::step, 0][keep] * xy_scale
    v = vf[::step, ::step, 1][keep] * xy_scale
    x = xs * xy_scale
    y = ys * xy_scale
    if uv_is_offset:
        u = u - x
        v = v - y
    order = np.argsort(cs, kind='stable')
    if reg_uncertainty is not None:
        rr = np.asarray(reg_uncertainty)[::step, ::step][keep] * xy_scale
        live = rr != 0
        draw.rings(ax.pixels, np.stack([x + u, y + v], -1)[live],
                   rr[live] / 2.0, _rgb('orange'))
    _arrows(ax.pixels, x[order], y[order], u[order], v[order],
            colormap(cs[order], cmap, clim))
    return len(order)


def margins(ax: Canvas, vector_field: np.ndarray,
            intensity_field: Optional[np.ndarray] = None, *, step: int = 1,
            threshold: float = 0.5, xy_scale: float = 1.0,
            uv_is_offset: bool = False, color='orange',
            alpha: float = 0.5 / 16.0):
    """Quadrant-margin wedges around regressed targets. vector_field is
    (H, W, >= 6): channels 0-1 the vector, 2-5 the four quadrant radii
    (NE, NW, SE, SW); non-finite radii are skipped."""
    vf = np.asarray(vector_field)
    xs, ys, _, keep = _field_grid(vf.shape, intensity_field, step,
                                  threshold)
    x = xs * xy_scale
    y = ys * xy_scale
    u = vf[::step, ::step, 0][keep] * xy_scale
    v = vf[::step, ::step, 1][keep] * xy_scale
    r = vf[::step, ::step, 2:6][keep] * xy_scale
    if uv_is_offset:
        u = u - x
        v = v - y
    wedge_angles = ((0.0, 90.0), (90.0, 180.0), (270.0, 360.0),
                    (180.0, 270.0))
    centers = np.stack([x + u, y + v], axis=-1)
    for q, (theta1, theta2) in enumerate(wedge_angles):
        draw.fill_wedges(ax.pixels, centers, r[:, q], theta1, theta2,
                         _rgb(color), alpha)


def arrows(ax: Canvas, fourd: np.ndarray, *, xy_scale: float = 1.0,
           threshold: float = 0.0, cmap: str = 'jet', clim=None) -> int:
    """Endpoint-pair association arrows. fourd is (2, 3, M): two endpoints
    x (x, y, v) x M associations; an association is kept when both
    endpoint confidences reach `threshold`, coloured by the weaker
    endpoint, weakest drawn first. Returns the arrow count."""
    fourd = np.asarray(fourd)
    c = np.min(fourd[:, 2], axis=0)
    keep = c >= threshold
    fourd = fourd[:, :, keep]
    c = c[keep]
    (x1, y1), (x2, y2) = fourd[:, :2, :] * xy_scale
    order = np.argsort(c, kind='stable')
    _arrows(ax.pixels, x1[order], y1[order], (x2 - x1)[order],
            (y2 - y1)[order], colormap(c[order], cmap, clim))
    return len(order)


def _scalar_field(ax, scalar_field, intensity_field, xy_scale, step,
                  threshold, cmap, clim, paint):
    sf = np.asarray(scalar_field)
    xs, ys, cs, keep = _field_grid(sf.shape, intensity_field, step,
                                   threshold)
    ss = sf[::step, ::step][keep] * xy_scale
    colors = colormap(cs, cmap, clim)
    for xx, yy, s, col in zip(xs * xy_scale, ys * xy_scale, ss, colors):
        paint(ax.pixels, xx, yy, s, col)


def boxes(ax: Canvas, scalar_field: np.ndarray,
          intensity_field: Optional[np.ndarray] = None, *,
          xy_scale: float = 1.0, step: int = 1, threshold: float = 0.5,
          cmap: str = 'jet_r', clim=(0.5, 1.0)):
    """Scale-field squares of half-size `scalar_field` (H, W), coloured
    by intensity."""
    def paint(img, x, y, s, col):
        c = np.array([[x - s, y - s], [x + s, y - s], [x + s, y + s],
                      [x - s, y + s]])
        draw.segments(img, c, np.roll(c, -1, 0), col)

    _scalar_field(ax, scalar_field, intensity_field, xy_scale, step,
                  threshold, cmap, clim, paint)


def circles(ax: Canvas, scalar_field: np.ndarray,
            intensity_field: Optional[np.ndarray] = None, *,
            xy_scale: float = 1.0, step: int = 1, threshold: float = 0.5,
            cmap: str = 'jet_r', clim=(0.5, 1.0)):
    """Scale-field circles of radius `scalar_field` (H, W), coloured by
    intensity."""
    def paint(img, x, y, s, col):
        draw.rings(img, [[x, y]], s, col)

    _scalar_field(ax, scalar_field, intensity_field, xy_scale, step,
                  threshold, cmap, clim, paint)


class CrowdPainter:
    """Shade crowd-region polygons."""

    def __init__(self, *, alpha: float = 0.5, color='orange'):
        self.alpha = alpha
        self.color = color

    def draw(self, ax: Canvas, outlines: Sequence[np.ndarray]):
        for outline in outlines:
            outline = np.asarray(outline)
            if outline.ndim != 2 or outline.shape[1] != 2:
                raise ValueError('outline must be (N, 2) xy points')
            draw.fill_polygon(ax.pixels, outline, _rgb(self.color),
                              self.alpha)


def white_screen(ax: Canvas, alpha: float = 0.9):
    """Wash the canvas with translucent white so overlays stand out."""
    ax.show_image(np.full((1, 1, 3), 255, np.uint8), alpha)


def load_image(path: str, scale: float = 1.0) -> np.ndarray:
    """An RGB image file (JPEG or PNG, through the port's codec) as
    float32 in [0, scale]."""
    img = codec.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img.astype(np.float32) * (scale / 255.0)
