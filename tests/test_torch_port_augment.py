"""The port's training data path against the JAX package's device-aug
route: host samples and batches (identical for a seed), the device warp,
annotation transform and photometric pass, and augment + encode end to
end. The hard set is written as lossless .png, which both sides read."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offsetguided_tpu.config.defaults import \
    AugmentationConfig as JAugmentationConfig
from offsetguided_tpu.config.defaults import EncoderConfig as JEncoderConfig
from offsetguided_tpu.data import pipeline as jpipeline
from offsetguided_tpu.ops import augment as jaugment
from offsetguided_tpu.ops.encoder import downscale_mask as jdownscale_mask
from offsetguided_tpu.ops.encoder import encode_targets as jencode_targets
from offsetguided_tpu_torch.config.defaults import (AugmentationConfig,
                                                    EncoderConfig,
                                                    SkeletonConfig)
from offsetguided_tpu_torch.data import pipeline
from offsetguided_tpu_torch.data.synthetic import make_hard_dataset
from offsetguided_tpu_torch.ops import augment
from offsetguided_tpu_torch.ops.encoder import downscale_mask, encode_targets

# the suite's worker processes share the host's cores
torch.set_num_threads(2)

SQUARE = 128
SPEC_KEYS = ('image', 'mask_miss', 'anns', 'aug_mat', 'aug_mat_inv',
             'aug_scale_xy', 'aug_flags', 'aug_tint', 'valid_hw')
# the JAX tests' augmentation bounds, with every random branch likely
AUG = dict(square_length=SQUARE, color_tint_prob=0.5, gray_prob=0.3,
           annotation_jitter_prob=0.5)


@pytest.fixture(scope='module')
def datasets(tmp_path_factory):
    img_dir, ann = make_hard_dataset(str(tmp_path_factory.mktemp('hard')),
                                     n_images=8, seed=0, ext='png')
    kw = dict(square_length=SQUARE, max_persons=12, device_aug=True)
    return (jpipeline.CocoKeypoints(img_dir, ann,
                                    aug=JAugmentationConfig(**AUG), **kw),
            pipeline.CocoKeypoints(img_dir, ann, aug=AugmentationConfig(**AUG),
                                   **kw))


def assert_same_sample(a, b):
    for k in SPEC_KEYS:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k, v in a['meta'].items():
        np.testing.assert_array_equal(np.asarray(b['meta'][k]), np.asarray(v),
                                      err_msg=k)


def test_host_samples_match_jax(datasets):
    """`get(i, _batch_rng(seed, epoch, batch))`: identical raw canvases,
    masks, annotations, matrices, flags, tints, valid sizes and metas."""
    jds, ds = datasets
    assert len(ds) == len(jds) == 8
    assert ds.sample_spec() == jds.sample_spec()
    flips = 0
    for i in range(8):
        a = jds.get(i, jpipeline._batch_rng(3, i % 2, i))
        b = ds.get(i, pipeline._batch_rng(3, i % 2, i))
        assert_same_sample(a, b)
        flips += int(b['aug_flags'][0])
    assert 0 < flips < 8


def test_batch_iterator_matches_jax(datasets):
    """The same shuffled order and the same batches for a seed, over two
    epochs (the last, short batch dropped)."""
    jds, ds = datasets
    kw = dict(seed=5, epochs=2)
    ours = list(pipeline.batch_iterator(ds, 3, **kw))
    ref = list(jpipeline.batch_iterator(jds, 3, **kw))
    assert len(ours) == len(ref) == 4
    for a, b in zip(ref, ours):
        assert a['epoch'] == b['epoch']
        assert [m['image_id'] for m in a['metas']] == \
            [m['image_id'] for m in b['metas']]
        for k in SPEC_KEYS:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_nearest_mask_resize_matches_cv2():
    """The canvas-overflow path's mask resize is cv2's INTER_NEAREST."""
    import cv2
    rng = np.random.RandomState(4)
    for h, w, th, tw in ((700, 900, 497, 640), (13, 7, 5, 11), (64, 64, 64, 64)):
        mask = (rng.rand(h, w) > 0.5).astype(np.uint8) * 255
        np.testing.assert_array_equal(
            pipeline._resize_nearest(mask, tw, th),
            cv2.resize(mask, (tw, th), interpolation=cv2.INTER_NEAREST))


def test_worker_batches_equal_serial(datasets):
    """Two loader processes yield the one-thread loader's device-aug
    batches (raw canvases, masks, parameters), in order."""
    _, ds = datasets
    kw = dict(seed=5, epochs=2)
    serial = list(pipeline.batch_iterator(ds, 3, **kw))
    par = list(pipeline.batch_iterator(ds, 3, num_workers=2, **kw))
    assert len(par) == len(serial) == 4
    for a, b in zip(serial, par):
        assert a['epoch'] == b['epoch']
        for k in SPEC_KEYS:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def random_warps(rng, n, h, w):
    """dst->src matrices with rotation and scale strong enough that the
    footprints cross every border, and valid sizes cropping the canvas."""
    mats = []
    for _ in range(n):
        th, s = rng.uniform(-0.8, 0.8), rng.uniform(0.4, 2.2)
        mats.append([[np.cos(th) * s, -np.sin(th) * s, rng.uniform(-20, 20)],
                     [np.sin(th) * s, np.cos(th) * s, rng.uniform(-20, 20)]])
    valid = np.array([[h, w], [h - 7, w - 11], [13, 9]][:n], np.int32)
    return np.asarray(mats, np.float32), valid


def exact_warp(images, mats, out_hw, border, valid):
    """The 16-tap warp in float64, tap by tap (the definition)."""
    n, h, w, c = images.shape
    ys, xs = np.mgrid[0:out_hw[0], 0:out_hw[1]].astype(np.float64)
    out = np.zeros((n,) + tuple(out_hw) + (c,))

    def cw(d):
        a, d = -0.75, np.abs(d)
        return np.where(d <= 1, (a + 2) * d ** 3 - (a + 3) * d ** 2 + 1,
                        np.where(d < 2, a * d ** 3 - 5 * a * d ** 2
                                 + 8 * a * d - 4 * a, 0.0))

    for i in range(n):
        m = mats[i].astype(np.float64)
        sx = m[0, 0] * xs + m[0, 1] * ys + m[0, 2]
        sy = m[1, 0] * xs + m[1, 1] * ys + m[1, 2]
        for dy in range(-1, 3):
            for dx in range(-1, 3):
                tx, ty = np.floor(sx) + dx, np.floor(sy) + dy
                inb = ((tx >= 0) & (tx < valid[i, 1]) & (ty >= 0)
                       & (ty < valid[i, 0]))
                v = images[i, np.clip(ty, 0, h - 1).astype(int),
                           np.clip(tx, 0, w - 1).astype(int)]
                out[i] += (cw(sy - ty) * cw(sx - tx))[..., None] * np.where(
                    inb[..., None], v, border)
    return out


def test_affine_sample_matches_jax():
    """The 4x4-footprint warp of a uint8 noise canvas with a 4-channel
    border, before quantization: within 1e-3 + 1e-5 of the value (pixels
    reach 255) of the JAX warp, and within 2e-3 of the exact float64 warp
    (each f32 warp is about 1.5e-3 from it on noise, where a coordinate's
    last-bit rounding moves the sample along a steep gradient); within
    1 LSB after quantization."""
    rng = np.random.RandomState(0)
    h, w = 45, 57
    images = (rng.rand(3, h, w, 4) * 255).astype(np.uint8)
    border = np.array([124.0, 116.0, 104.0, 255.0], np.float32)
    for _ in range(3):
        mats, valid = random_warps(rng, 3, h, w)
        ref = np.asarray(jaugment.affine_sample(
            jnp.asarray(images), jnp.asarray(mats), (31, 50),
            jnp.asarray(border), jnp.asarray(valid), row_chunk=8))
        ours = augment.affine_sample(
            torch.from_numpy(images), torch.from_numpy(mats), (31, 50),
            torch.from_numpy(border), torch.from_numpy(valid),
            row_chunk=8).numpy()
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(
            ours, exact_warp(images, mats, (31, 50), border, valid),
            rtol=0, atol=2e-3)
        q = lambda x: np.clip(np.round(x), 0, 255).astype(int)
        assert np.abs(q(ours) - q(ref)).max() <= 1


def test_transform_annotations_matches_jax():
    rng = np.random.RandomState(1)
    sk = SkeletonConfig()
    left = [i for i, n in enumerate(sk.keypoints) if n.startswith('left')]
    right = [i for i, n in enumerate(sk.keypoints) if n.startswith('right')]
    anns = np.zeros((4, 5, 17, 4), np.float32)
    anns[:, :4, :, :2] = rng.rand(4, 4, 17, 2) * 300
    anns[:, :4, :, 2] = (rng.rand(4, 4, 17) < 0.8) * 2.0
    anns[:, :4, :, 3] = rng.rand(4, 4, 17) * 20
    mats = np.tile(np.eye(3, dtype=np.float32), (4, 1, 1))
    mats[:, :2] = rng.randn(4, 2, 3).astype(np.float32) * [0.8, 0.8, 60]
    scale_xy = rng.uniform(0.5, 2.0, (4, 2)).astype(np.float32)
    flips = np.array([True, False, True, False])
    ref = np.asarray(jaugment.transform_annotations(
        jnp.asarray(anns), jnp.asarray(mats), jnp.asarray(scale_xy),
        jnp.asarray(flips), left, right, 128))
    ours = augment.transform_annotations(
        torch.from_numpy(anns), torch.from_numpy(mats),
        torch.from_numpy(scale_xy), torch.from_numpy(flips), left, right,
        128).numpy()
    np.testing.assert_array_equal(ours[..., 2], ref[..., 2])
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
    assert (ref[..., 2] > 0).any() and (ref[..., 2] == 0).any()


def test_photometric_matches_jax():
    """Grayscale and HSV tint on float pixels, both flags on and off:
    within 1 LSB after quantization."""
    rng = np.random.RandomState(2)
    images = (rng.rand(4, 16, 20, 3) * 255).astype(np.float32)
    images[0, :4] = 128.0                       # grey pixels: zero saturation
    grays = np.array([False, True, False, True])
    tints = np.array([[1, 7, -30, 20], [0, 0, 0, 0], [1, -10, 40, -30],
                      [1, 3, 5, 5]], np.float32)
    ref = np.asarray(jaugment.photometric(jnp.asarray(images),
                                          jnp.asarray(grays),
                                          jnp.asarray(tints)))
    ours = augment.photometric(torch.from_numpy(images),
                               torch.from_numpy(grays),
                               torch.from_numpy(tints)).numpy()
    q = lambda x: np.clip(np.round(x), 0, 255).astype(int)
    assert np.abs(q(ours) - q(ref)).max() <= 1
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-2)


def test_augment_and_encode_match_jax(datasets):
    """One host batch through `augment_batch_dict` (the JAX package's with
    its patch warp), then `encode_targets` and `downscale_mask`: images
    within 1 LSB, the warped mask within 1e-3, annotations within 1e-4 px,
    targets within the encoder tests' 1e-6 with identical sentinels."""
    jds, ds = datasets
    batch = pipeline._make_batch(ds, [0, 3, 5], pipeline._batch_rng(1, 0, 0), 0)
    jb = {k: jnp.asarray(batch[k]) for k in SPEC_KEYS}
    ji, jm, ja = jaugment.augment_batch_dict(jb, SQUARE, jds.left_index,
                                             jds.right_index,
                                             warp_impl='patch')
    tb = {k: torch.from_numpy(batch[k]) for k in SPEC_KEYS}
    ti, tm, ta = augment.augment_batch_dict(tb, SQUARE, ds.left_index,
                                            ds.right_index,
                                            warp_impl='patch')
    assert ti.dtype == torch.uint8 and ti.shape == (3, SQUARE, SQUARE, 3)
    assert np.abs(ti.numpy().astype(int) - np.asarray(ji).astype(int)).max() <= 1
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(ta.numpy()[..., 2], np.asarray(ja)[..., 2])
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-4)
    assert (ta.numpy()[..., 2] > 0).sum() > 10

    sk = SkeletonConfig()
    out = SQUARE // 4
    ref = jencode_targets(ja, np.asarray(sk.sigmas), sk.skeleton, out, out,
                          JEncoderConfig(max_persons=12))
    ours = encode_targets(ta, sk.sigmas, sk.skeleton, out, out,
                          EncoderConfig(max_persons=12))
    for name in ref._fields:
        a, b = np.asarray(getattr(ref, name)), getattr(ours, name).numpy()
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b), err_msg=name)
        fin = np.isfinite(a)
        np.testing.assert_allclose(b[fin], a[fin], rtol=0, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_array_equal(
        downscale_mask(tm, EncoderConfig()).numpy(),
        np.asarray(jdownscale_mask(jm, JEncoderConfig())))


def test_warp_slope_bound_matches_jax():
    for kw in ({}, dict(min_scale=0.3, min_stretch=0.9),
               dict(min_stretch=1.2)):
        assert augment.warp_slope_bound(AugmentationConfig(**kw)) == \
            jaugment.warp_slope_bound(JAugmentationConfig(**kw))
