"""The port's host augmentation route against the JAX package's cv2 route,
on the CPU: the warp (image and miss mask), keypoints and meta over
fuzzed affines; gray and tint; host-route and validation samples of
`CocoKeypoints` on the hard set written as .png (both packages read it);
and the loader's worker processes (identical batches for any worker
count, nothing left behind when closed).

Tolerance: identical. The warp's share of differing values is measured
and asserted to be 0 (the JAX package's `cv2.warpAffine` is OpenCV 5.0's
float32 cubic warp, which `data/pixels.py` repeats in its operation
order)."""
import ast
import math
import multiprocessing as mp
import os
import pathlib

import cv2
import numpy as np
import pytest

from offsetguided_tpu.config.defaults import \
    AugmentationConfig as JAugmentationConfig
from offsetguided_tpu.data import pipeline as jpipeline
from offsetguided_tpu.data import transforms as JT
from offsetguided_tpu_torch.config.defaults import (AugmentationConfig,
                                                    SkeletonConfig)
from offsetguided_tpu_torch.data import pipeline, pixels
from offsetguided_tpu_torch.data import transforms as T
from offsetguided_tpu_torch.data.synthetic import make_hard_dataset
from offsetguided_tpu_torch.ops.cuda import _build

SQUARE = 128
# every random branch likely: jitter, gray and tint
AUG = dict(square_length=SQUARE, color_tint_prob=0.5, gray_prob=0.3,
           annotation_jitter_prob=0.5)
HOST_KEYS = ('image', 'mask_miss', 'anns')
SK = SkeletonConfig()
LEFT = [i for i, n in enumerate(SK.keypoints) if n.startswith('left')]
RIGHT = [i for i, n in enumerate(SK.keypoints) if n.startswith('right')]


def fuzz_case(rng, i):
    """A source image, mask, annotations and meta, and augmentation
    parameters: flip, rotation up to 45 degrees, scale 0.5-2, stretch,
    offsets that push the warp off the canvas; sources smaller and larger
    than 512^2, with 1-pixel edges among them."""
    h, w = rng.randint(1, 700), rng.randint(1, 700)
    if i % 8 == 0:
        h = 1
    elif i % 8 == 1:
        w = 1
    image = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    mask = (rng.rand(h, w) > 0.3).astype(np.uint8) * 255
    anns = np.zeros((3, 17, 4), np.float32)
    anns[..., 0] = rng.rand(3, 17) * w
    anns[..., 1] = rng.rand(3, 17) * h
    anns[..., 2] = rng.randint(0, 3, (3, 17))
    anns[..., 3] = rng.rand(3, 17) * 20
    params = dict(flip=bool(rng.rand() < 0.5),
                  rotate=float(rng.uniform(-45, 45)),
                  scale=float(rng.uniform(0.5, 2.0)),
                  x_stretch=float(rng.uniform(0.95, 1.05)),
                  y_stretch=float(rng.uniform(0.95, 1.05)),
                  x_offset=int(rng.uniform(-300, 300)),
                  y_offset=int(rng.uniform(-300, 300)))
    return image, mask, anns, params


def test_warp_affine_matches_jax():
    """40 fuzzed warps to 128^2-512^2 squares: image (PAD_RGB border),
    mask (border 255), keypoints and every meta entry identical to the JAX
    package's cv2 warp. Measured share of differing pixel values: 0."""
    rng = np.random.RandomState(0)
    differing = total = 0
    for i in range(40):
        image, mask, anns, params = fuzz_case(rng, i)
        h, w = image.shape[:2]
        size = (128, 256, 512)[i % 3]
        meta = T.make_meta(w, h)
        ref = JT.warp_affine(image, anns, JT.make_meta(w, h), mask, params,
                             size, LEFT, RIGHT)
        out = T.warp_affine(image, anns, meta, mask, params, size, LEFT,
                            RIGHT)
        for r, o in ((ref[0], out[0]), (ref[3], out[3])):
            assert r.shape == o.shape and o.dtype == np.uint8
            differing += int((r != o).sum())
            total += r.size
        np.testing.assert_array_equal(out[1], ref[1])
        assert ref[2].keys() == out[2].keys()
        for k, v in ref[2].items():
            np.testing.assert_array_equal(np.asarray(out[2][k]),
                                          np.asarray(v), err_msg=k)
    assert total > 10_000_000 and differing / total == 0.0


def test_native_warp_equals_numpy_definition():
    """The C++ warp (the loader's) equals the numpy definition value for
    value, and both equal cv2.warpAffine, on 3- and 1-channel sources."""
    rng = np.random.RandomState(1)
    for i in range(6):
        image, mask, _, params = fuzz_case(rng, i + 2)
        th = math.radians(params['rotate'])
        s = params['scale'] * (-1 if params['flip'] else 1)
        m = np.array([[s * math.cos(th), math.sin(th), params['x_offset']],
                      [-math.sin(th), params['scale'] * math.cos(th),
                       params['y_offset']]])
        for src, border in ((image, (124, 116, 104)), (mask, 255)):
            ref = cv2.warpAffine(src, m, (96, 80), flags=cv2.INTER_CUBIC,
                                 borderMode=cv2.BORDER_CONSTANT,
                                 borderValue=border)
            np.testing.assert_array_equal(
                pixels.warp_affine_u8(src, m, 96, 80, border), ref)
            np.testing.assert_array_equal(
                pixels.warp_affine_u8_native(src, m, 96, 80, border), ref)


def test_fma32_is_correctly_rounded():
    """The numpy fused multiply-add rounds a*b + c once. (1 + 2^-12)^2 =
    1 + 2^-11 + 2^-24 lies on a float32 midpoint: alone it rounds to even,
    and a c of +-2^-60, which the double sum loses, decides the side."""
    a = np.float32(1 + 2 ** -12)
    low = np.float32(1 + 2 ** -11)
    high = np.nextafter(low, np.float32(2))
    assert pixels.fma32(a, a, np.float32(0)) == low
    assert pixels.fma32(a, a, np.float32(2 ** -60)) == high
    assert pixels.fma32(a, a, np.float32(-2 ** -60)) == low
    assert pixels.fma32(-a, a, np.float32(-2 ** -60)) == -high


def test_gray_and_hsv_match_cv2_on_every_color():
    """RGB2GRAY and RGB2HSV on all 2^24 colors, HSV2RGB on all 180 * 2^16
    hue/saturation/value triples: identical to cv2, in rows of 4096 pixels
    (OpenCV's 32-pixel vector blocks) and in rows of 1 (its scalar
    tails)."""
    c = np.arange(1 << 24, dtype=np.int64)
    rgb = np.stack([c >> 16, (c >> 8) & 255, c & 255],
                   -1).astype(np.uint8).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(pixels.rgb_to_gray_u8(rgb),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))
    np.testing.assert_array_equal(pixels.rgb_to_hsv_u8(rgb),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))
    c = np.arange(180 << 16, dtype=np.int64)
    hsv = np.stack([c >> 16, (c >> 8) & 255, c & 255],
                   -1).astype(np.uint8).reshape(180 * 16, 4096, 3)
    np.testing.assert_array_equal(pixels.hsv_to_rgb_u8(hsv),
                                  cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
    tails = ((pixels.rgb_to_gray_u8, rgb, cv2.COLOR_RGB2GRAY),
             (pixels.rgb_to_hsv_u8, rgb, cv2.COLOR_RGB2HSV),
             (pixels.hsv_to_rgb_u8, hsv, cv2.COLOR_HSV2RGB))
    for fn, img, code in tails:
        col = img.reshape(-1, 1, 3)
        np.testing.assert_array_equal(fn(col), cv2.cvtColor(col, code))


def test_to_gray_and_color_tint_match_jax():
    """`to_gray` and `color_tint` (its three draws in the JAX package's
    order) identical on noise for 20 seeds, and the RNG left in the same
    state."""
    img = np.random.RandomState(2).randint(0, 256, (97, 131, 3), np.uint8)
    np.testing.assert_array_equal(T.to_gray(img), JT.to_gray(img))
    for seed in range(20):
        r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
        np.testing.assert_array_equal(T.color_tint(img, r1),
                                      JT.color_tint(img, r2))
        assert r1.rand() == r2.rand()


@pytest.fixture(scope='module')
def hard_set(tmp_path_factory):
    return make_hard_dataset(str(tmp_path_factory.mktemp('hard')),
                             n_images=8, seed=0, ext='png')


@pytest.fixture(scope='module')
def datasets(hard_set):
    img_dir, ann = hard_set
    kw = dict(square_length=SQUARE, max_persons=12)
    return (jpipeline.CocoKeypoints(img_dir, ann,
                                    aug=JAugmentationConfig(**AUG), **kw),
            pipeline.CocoKeypoints(img_dir, ann,
                                   aug=AugmentationConfig(**AUG), **kw))


def assert_same_sample(a, b):
    for k in HOST_KEYS:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert a['meta'].keys() == b['meta'].keys()
    for k, v in a['meta'].items():
        np.testing.assert_array_equal(np.asarray(b['meta'][k]),
                                      np.asarray(v), err_msg=k)


def test_host_samples_match_jax(datasets):
    """`get(i, _batch_rng(seed, epoch, batch))` on the host route: image,
    mask, annotations and meta identical, with flips, grays and tints
    drawn."""
    jds, ds = datasets
    assert ds.sample_spec() == jds.sample_spec()
    flips = 0
    for i in range(8):
        a = jds.get(i, jpipeline._batch_rng(3, i % 2, i))
        b = ds.get(i, pipeline._batch_rng(3, i % 2, i))
        assert_same_sample(a, b)
        flips += int(b['meta']['hflip'])
    assert 0 < flips < 8


def test_validation_samples_match_jax(hard_set):
    """`aug=None` (the validation dataset): the identity placement on the
    square, identical, with no draw from the RNG."""
    img_dir, ann = hard_set
    kw = dict(aug=None, square_length=SQUARE, max_persons=12)
    jds = jpipeline.CocoKeypoints(img_dir, ann, **kw)
    ds = pipeline.CocoKeypoints(img_dir, ann, **kw)
    for i in range(len(ds)):
        rng = np.random.RandomState(0)
        assert_same_sample(jds.get(i, None), ds.get(i, rng))
        assert rng.rand() == np.random.RandomState(0).rand()


def test_host_batches_match_jax(datasets):
    """The serial iterator gives the JAX package's batches for a seed."""
    jds, ds = datasets
    ours = list(pipeline.batch_iterator(ds, 3, seed=5, epochs=2))
    ref = list(jpipeline.batch_iterator(jds, 3, seed=5, epochs=2))
    assert len(ours) == len(ref) == 4
    for a, b in zip(ref, ours):
        assert a['epoch'] == b['epoch']
        for k in HOST_KEYS:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.mark.parametrize('num_workers', [1, 2, 3])
def test_worker_batches_equal_serial(datasets, num_workers):
    """Loader processes yield the serial path's batches, in order: same
    arrays, metas and epochs, over two epochs."""
    _, ds = datasets
    kw = dict(seed=5, epochs=2)
    serial = list(pipeline.batch_iterator(ds, 3, **kw))
    par = list(pipeline.batch_iterator(ds, 3, num_workers=num_workers,
                                       **kw))
    assert len(par) == len(serial) == 4
    for a, b in zip(serial, par):
        assert a['epoch'] == b['epoch']
        assert [m['image_id'] for m in a['metas']] == \
            [m['image_id'] for m in b['metas']]
        for k in ds.sample_spec():
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.fixture
def segments(monkeypatch):
    """The names of the shared-memory segments the loader creates in this
    test (other test processes may hold their own at the same time)."""
    names = []
    create = pipeline._ShmSlots.create

    def recording(self):
        names.extend(create(self))
        return names[-self.n_slots:]
    monkeypatch.setattr(pipeline._ShmSlots, 'create', recording)
    return names


def alive(names):
    return [n for n in names if os.path.exists(os.path.join('/dev/shm', n))]


def test_closing_worker_iterator_leaves_nothing(datasets, segments):
    """Closing an endless worker iterator mid-stream ends every worker
    process and unlinks every shared-memory segment it made."""
    _, ds = datasets
    it = pipeline.batch_iterator(ds, 2, seed=1, epochs=None, num_workers=3)
    next(it)
    next(it)
    assert len(mp.active_children()) == 3
    assert len(alive(segments)) == 3 + 2       # workers + prefetch
    it.close()
    assert mp.active_children() == []
    assert alive(segments) == []


def test_worker_error_surfaces(hard_set, segments):
    """A sample that fails in a worker raises in the parent, which still
    cleans up."""
    img_dir, ann = hard_set
    ds = pipeline.CocoKeypoints(img_dir, ann, aug=AugmentationConfig(**AUG),
                                square_length=SQUARE, max_persons=12)
    ds.image_dir = os.path.join(img_dir, 'missing')
    with pytest.raises(RuntimeError, match='loader worker failed'):
        list(pipeline.batch_iterator(ds, 2, epochs=1, num_workers=2))
    assert mp.active_children() == []
    assert segments and alive(segments) == []


def test_host_warp_build_failure_raises(tmp_path, monkeypatch):
    """A host warp that does not build is an error, never a silent numpy
    path: the dataset's construction raises."""
    (tmp_path / 'host_warp.cpp').write_text('this is not C++\n')
    monkeypatch.setattr(_build, 'CSRC', tmp_path)
    monkeypatch.setattr(_build, 'BUILD', tmp_path / 'build')
    monkeypatch.setattr(_build, '_libs', {})
    with pytest.raises(RuntimeError, match='host_warp.cpp'):
        pipeline.CocoKeypoints(*make_hard_dataset(str(tmp_path / 'd'),
                                                  n_images=1, ext='npy'),
                               aug=AugmentationConfig(**AUG))


def test_host_route_imports_no_cv2():
    """The host route, the self-check and the loader benchmark need no
    OpenCV (the card's host has none): no module of theirs imports cv2."""
    pkg = pathlib.Path(T.__file__).resolve().parents[1]
    for rel in ('data/pixels.py', 'data/transforms.py', 'data/pipeline.py',
                'cli/train.py', 'cli/selfcheck.py', 'cli/bench_data.py'):
        for node in ast.walk(ast.parse((pkg / rel).read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ''] if isinstance(node, ast.ImportFrom)
                     else [])
            assert 'cv2' not in {n.split('.')[0] for n in names}, rel
