"""The port's raster painter (`visualization/show.py`, `data/draw.py`):
matplotlib's tab20 and jet tables carried as constants (equal to
matplotlib's, which is installed here and nowhere in the port), the
skeleton painter's colours, solid and dashed limbs, markers, box and
score, the canvases written as PNG through the codec, and each field
renderer painting where its data says."""
import subprocess
import sys

import matplotlib
import numpy as np
import pytest

from offsetguided_tpu_torch.config.defaults import SkeletonConfig
from offsetguided_tpu_torch.data import codec, draw
from offsetguided_tpu_torch.visualization import show


def test_tab20_equals_matplotlib():
    ref = np.array(matplotlib.colormaps['tab20'].colors)
    np.testing.assert_array_equal(show.TAB20 / 255.0, ref)


def test_jet_equals_matplotlib():
    """The 256-entry table within 1e-15, and values mapped to the same bin
    as matplotlib's `Normalize` + colormap call (uint8 within one level:
    the table holds exact halves that round either way)."""
    jet = matplotlib.colormaps['jet']
    np.testing.assert_allclose(show.JET, jet(np.arange(256))[:, :3],
                               rtol=0, atol=1e-15)
    v = np.random.RandomState(0).randn(5000)
    want = jet(matplotlib.colors.Normalize(v.min(), v.max())(v))[:, :3]
    got = show.colormap(v)
    assert np.abs(got.astype(float) - want * 255.0).max() <= 0.5 + 1e-9
    np.testing.assert_array_equal(show.colormap(v, 'jet_r'),
                                  show.colormap(-v))


def poses_two_people():
    """Two separated 17-keypoint people on a 160 x 200 canvas; the second
    has low scores (dashed limbs) and one missing keypoint."""
    poses = np.zeros((2, 17, 3))
    poses[:, :, 1] = np.linspace(20, 140, 17)
    poses[0, :, 0] = np.linspace(15, 80, 17)
    poses[1, :, 0] = np.linspace(110, 185, 17)
    poses[0, :, 2] = 0.9
    poses[1, :, 2] = 0.3
    poses[1, 5, 2] = 0.0
    return poses


def test_keypoint_painter_colours_each_person():
    poses = poses_two_people()
    with show.image_canvas(np.zeros((160, 200, 3), np.uint8)) as ax:
        show.KeypointPainter().keypoints(ax, poses)
    px = ax.pixels
    for i, pose in enumerate(poses):
        for x, y, v in pose:
            if v > 0:
                np.testing.assert_array_equal(
                    px[int(round(y)), int(round(x))], show.TAB20[i])
    x, y = np.rint(poses[1, 5, :2]).astype(int)       # missing: no marker
    assert (px[y - 1:y + 2, x - 1:x + 2] != show.TAB20[1]).any()
    assert {tuple(c) for c in px.reshape(-1, 3)} <= \
        {(0, 0, 0), tuple(show.TAB20[0]), tuple(show.TAB20[1])}


def test_limbs_solid_above_threshold_dashed_below():
    """A limb between two keypoints above `highlight_threshold` covers its
    whole segment; below it, dashes of 6 pixels and gaps of 4 (each edge
    within a pixel)."""
    pose = np.zeros((1, 17, 3))
    pose[0, 0] = (10, 20, 0.9)
    pose[0, 1] = (110, 20, 0.9)
    pose[0, 2] = (10, 60, 0.2)
    pose[0, 3] = (110, 60, 0.2)
    painter = show.KeypointPainter(markersize=0, linewidth=1,
                                   skeleton_cfg=SkeletonConfig())
    with show.canvas(height=80, width=120) as ax:
        painter.keypoints(ax, pose, skeleton=((0, 1), (2, 3)))
    white = (ax.pixels == 255).all(-1)
    assert not white[20, 10:111].any()               # solid
    row = white[60, 10:111]
    assert row.any() and not row.all()                # dashed
    assert (~row[:6]).all() and row[7:10].all()       # 6 on, 4 off


def test_show_box_draws_box_and_score():
    poses = poses_two_people()[:1]
    with show.canvas(height=160, width=200) as ax:
        show.KeypointPainter(show_box=True).keypoints(ax, poses,
                                                      scores=[0.87])
    col = show.TAB20[0]
    painted = (ax.pixels == col).all(-1)
    x0, y0 = np.rint(poses[0, :, :2].min(0)).astype(int)
    x1, y1 = np.rint(poses[0, :, :2].max(0)).astype(int)
    assert painted[y0, x0:x1 + 1].all() and painted[y0:y1 + 1, x1].all()
    assert painted[y0 - 12:y0 - 2, x0:x0 + 30].any()   # the score text


def test_text_glyphs():
    img = np.zeros((10, 40, 3), np.uint8)
    draw.text(img, 0, 0, '0.1', (255, 255, 255), scale=1)
    lit = img[..., 0] > 0
    np.testing.assert_array_equal(lit[:5, 0:3], [[1, 1, 1], [1, 0, 1],
                                                 [1, 0, 1], [1, 0, 1],
                                                 [1, 1, 1]])
    assert lit[4, 5] and lit[:4, 4:7].sum() == 0         # the point
    with pytest.raises(ValueError):
        draw.text(img, 0, 0, 'x', (1, 1, 1))


def test_image_canvas_writes_png_the_codec_reads(tmp_path):
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (37, 53, 3), dtype=np.uint8)
    path = str(tmp_path / 'a.png')
    with show.image_canvas(img, path) as ax:
        show.KeypointPainter().keypoints(ax, poses_two_people() * 0.3)
    back = codec.imread(path)
    np.testing.assert_array_equal(back, ax.pixels)
    with show.image_canvas(img / 255.0 * 0.5 + 0.5) as ax2:
        pass                                     # floats as in [0, 1]
    assert np.abs(ax2.pixels - (img * 0.5 + 127.5)).max() <= 0.5
    np.testing.assert_allclose(show.load_image(path, 2.0),
                               back.astype(np.float32) * 2.0 / 255.0)
    with pytest.raises(FileNotFoundError):
        show.load_image(str(tmp_path / 'missing.png'))


def test_heatmap_overlay_blends_jet():
    """A (4, 5, 2) heatmap over a (40, 50) grey image: each pixel is half
    the image and half jet of its cell's channel max (nearest)."""
    rng = np.random.RandomState(2)
    hmp = rng.rand(4, 5, 2)
    grey = np.full((40, 50, 3), 100, np.uint8)
    with show.image_canvas(grey) as ax:
        show.heatmap_overlay(ax, grey, hmp)
    want = np.rint(0.5 * 100 + 0.5 * show.colormap(hmp.max(-1)).astype(float))
    np.testing.assert_array_equal(ax.pixels[::10, ::10], want)
    with show.image_canvas(grey) as ax:
        show.heatmap_overlay(ax, grey, hmp, channel=1)
    want = np.rint(0.5 * 100 + 0.5 * show.colormap(hmp[..., 1]).astype(float))
    np.testing.assert_array_equal(ax.pixels[::10, ::10], want)


def test_limb_offset_arrows_start_at_finite_cells():
    omp = np.full((8, 8, 4), np.inf, np.float32)
    omp[2, 4, 2:] = (10.0, 0.0)                  # limb 1 at cell (2, 4)
    with show.canvas(height=32, width=48) as ax:
        show.draw_limb_offset(ax, omp, 1)
    cyan = (ax.pixels == (0, 255, 255)).all(-1)
    x, y = int(np.rint(4 * 4 + 1.5)), int(np.rint(2 * 4 + 1.5))
    assert cyan[y, x:x + 11].all()              # the shaft, 10 px right
    assert cyan[:, :x].sum() == 0 and cyan[y + 4:].sum() == 0


def test_field_renderers_paint_kept_cells_only():
    """quiver, arrows, boxes and circles draw only where the intensity
    passes the threshold; margins and the crowd polygon fill; the white
    wash lifts every pixel."""
    vf = np.zeros((10, 10, 6))
    vf[..., 0] = 2.0
    vf[..., 2:6] = 3.0
    inten = np.zeros((10, 10))
    inten[5, 5] = 1.0
    with show.canvas(height=40, width=40) as ax:
        ax.pixels[:] = 0
        assert show.quiver(ax, vf[..., :2], inten, xy_scale=4.0,
                           reg_uncertainty=np.ones((10, 10))) == 1
    lit = ax.pixels.any(-1)
    assert lit[20, 20] and lit[:12].sum() == 0
    with show.canvas(height=40, width=40) as ax:
        ax.pixels[:] = 0
        show.margins(ax, vf, inten, xy_scale=4.0, alpha=1.0)
        show.boxes(ax, np.full((10, 10), 2.0), inten, xy_scale=4.0)
        show.circles(ax, np.full((10, 10), 2.0), inten, xy_scale=4.0)
    lit = ax.pixels.any(-1)
    assert lit[18:24, 26:31].any() and lit[:8].sum() == 0   # radius 12
    fourd = np.array([[[5, 30], [5, 30], [0.9, 0.1]],
                      [[15, 35], [5, 35], [0.9, 0.9]]], np.float64)
    with show.canvas(height=40, width=40) as ax:
        ax.pixels[:] = 0
        assert show.arrows(ax, fourd, threshold=0.5) == 1
    assert ax.pixels[5, 10].any() and not ax.pixels[32:, 30:].any()
    with show.canvas(height=40, width=40) as ax:
        ax.pixels[:] = 0
        show.CrowdPainter(alpha=1.0).draw(
            ax, [np.array([[5, 5], [30, 5], [30, 30], [5, 30]])])
        with pytest.raises(ValueError):
            show.CrowdPainter().draw(ax, [np.zeros((3, 3))])
    orange = (ax.pixels == (255, 165, 0)).all(-1)
    assert orange[6:30, 6:30].all() and not orange[31:].any()
    show.white_screen(ax, 0.5)
    assert ax.pixels.min() >= 127


def test_segments_clip_far_endpoints():
    """A segment to a far off-image sentinel (the decoder's -1e5) draws
    its visible part without sampling the whole length."""
    img = np.zeros((20, 20, 3), np.uint8)
    draw.segments(img, [10, 10], [-1e5, 10], (255, 0, 0))
    assert (img[10, :11, 0] == 255).all() and img[10, 12:, 0].sum() == 0


def test_painter_imports_no_matplotlib():
    code = ('import sys, offsetguided_tpu_torch.visualization, '
            'offsetguided_tpu_torch.cli.demo; '
            'assert "matplotlib" not in sys.modules')
    subprocess.run([sys.executable, '-c', code], check=True)
