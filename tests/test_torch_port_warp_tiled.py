"""The port's tiled warp (`ops/augment.py::affine_sample_tiled`, windowed
banded matmuls) against the JAX package's and against the port's patch
warp, on the JAX package's own cases (tests/test_device_aug.py: a source
window smaller than the image, cropped `valid_hw`, every tap off the image)
at its tolerance, rtol 1e-3 / atol 0.05 of 255 (accumulation order, far
below the final uint8 rounding); the tiled route of `augment_batch_dict`
against the JAX package's (its default); the full-fp32 matmul whatever the
caller's TF32 setting; and the chunking of tiles."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offsetguided_tpu.config.defaults import \
    AugmentationConfig as JAugmentationConfig
from offsetguided_tpu.data import pipeline as jpipeline
from offsetguided_tpu.ops import augment as jaugment
from offsetguided_tpu_torch.config.defaults import AugmentationConfig
from offsetguided_tpu_torch.data import pipeline
from offsetguided_tpu_torch.data.synthetic import make_hard_dataset
from offsetguided_tpu_torch.ops import augment

# the suite's worker processes share the host's cores
torch.set_num_threads(2)

RTOL, ATOL = 1e-3, 0.05
BORDER = np.array([124.0, 116.0, 104.0, 255.0], np.float32)
SHAPES = {'small': (45, 57, 31, 50), 'sub_window': (400, 360, 128, 144)}


def jax_case(name: str, trial: int):
    """The images, matrices and valid sizes of the JAX test's `trial` at
    `SHAPES[name]` (trial 2: scale 4 and a 5000-pixel shift, all border)."""
    h, w, oh, ow = SHAPES[name]
    rng = np.random.RandomState(100 * list(SHAPES).index(name) + trial)
    images = (rng.rand(2, h, w, 4) * 255).astype(np.uint8)
    th = rng.uniform(-0.8, 0.8)
    s = rng.uniform(0.4, 2.1) if trial < 2 else 4.0
    off = 20 if trial < 2 else 5000
    mats = np.stack([np.array(
        [[np.cos(th) * s, -np.sin(th) * s, rng.uniform(-off, off)],
         [np.sin(th) * s, np.cos(th) * s, rng.uniform(-off, off)]],
        np.float32) for _ in range(2)])
    valid = np.stack([[h, w], [h - 7, w - 11]]).astype(np.int32)
    return images, mats, valid, (oh, ow)


def tiled(images, mats, valid, out_hw, **kw):
    return augment.affine_sample_tiled(
        torch.from_numpy(images), torch.from_numpy(mats), out_hw,
        torch.from_numpy(BORDER), torch.from_numpy(valid), slope_bound=4.5,
        **kw).numpy()


@pytest.mark.parametrize('trial', [0, 1, 2])
@pytest.mark.parametrize('name', list(SHAPES))
def test_tiled_warp_matches_jax_and_patch(name, trial):
    images, mats, valid, out_hw = jax_case(name, trial)
    ours = tiled(images, mats, valid, out_hw)
    ref = np.asarray(jaugment.affine_sample_tiled(
        jnp.asarray(images), jnp.asarray(mats), out_hw, jnp.asarray(BORDER),
        jnp.asarray(valid), slope_bound=4.5))
    patch = augment.affine_sample(
        torch.from_numpy(images), torch.from_numpy(mats), out_hw,
        torch.from_numpy(BORDER), torch.from_numpy(valid)).numpy()
    assert ours.shape == ref.shape == (2,) + out_hw + (4,)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours, patch, rtol=RTOL, atol=ATOL)
    if trial == 2:                      # every tap off the image
        np.testing.assert_allclose(ours, np.broadcast_to(BORDER, ours.shape),
                                   rtol=0, atol=1e-3)


def test_tiled_warp_window_is_a_sub_window():
    """At the JAX test's large shape the static window (slope 4.5, tiles of
    8 x 64: 320 rows and columns) is smaller than the 400 x 360 image, so
    the window origin and clipping are exercised."""
    span = int(np.ceil(4.5 * 63 + 4.5 * 7)) + 5
    assert span < min(SHAPES['sub_window'][:2])


def test_tiled_warp_chunks_agree(monkeypatch):
    """Tiles processed in chunks of one give the same bits as one chunk."""
    images, mats, valid, out_hw = jax_case('small', 0)
    whole = tiled(images, mats, valid, out_hw)
    monkeypatch.setattr(augment, 'TILE_CHUNK_BYTES', 1)
    np.testing.assert_array_equal(tiled(images, mats, valid, out_hw), whole)


def test_tiled_warp_matmul_in_full_fp32(monkeypatch):
    """With the caller's float32 matmul precision at 'high' (TF32 allowed),
    the warp's products run at 'highest' with TF32 off, and the caller's
    setting comes back after."""
    seen = []
    bmm = torch.bmm

    def spy(a, b):
        seen.append((torch.get_float32_matmul_precision(),
                     torch.backends.cuda.matmul.allow_tf32))
        return bmm(a, b)

    images, mats, valid, out_hw = jax_case('small', 1)
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision('high')
    try:
        monkeypatch.setattr(torch, 'bmm', spy)
        tiled(images, mats, valid, out_hw)
        assert torch.get_float32_matmul_precision() == 'high'
    finally:
        torch.set_float32_matmul_precision(saved)
    assert seen and set(seen) == {('highest', False)}


@pytest.fixture(scope='module')
def datasets(tmp_path_factory):
    img_dir, ann = make_hard_dataset(str(tmp_path_factory.mktemp('hard')),
                                     n_images=4, seed=0, ext='png')
    aug = dict(square_length=128, color_tint_prob=0.5, gray_prob=0.3,
               annotation_jitter_prob=0.5)
    kw = dict(square_length=128, max_persons=12, device_aug=True)
    return (jpipeline.CocoKeypoints(img_dir, ann,
                                    aug=JAugmentationConfig(**aug), **kw),
            pipeline.CocoKeypoints(img_dir, ann, aug=AugmentationConfig(**aug),
                                   **kw))


def test_augment_batch_dict_tiled_matches_jax(datasets):
    """One host batch through both packages' `augment_batch_dict` at their
    default, the tiled warp (slope bound 3.0): images within 1 LSB, the
    warped mask within 1e-3, annotations within 1e-4 px."""
    jds, ds = datasets
    batch = pipeline._make_batch(ds, [0, 1, 3], pipeline._batch_rng(1, 0, 0),
                                 0)
    keys = ds.sample_spec()
    ji, jm, ja = jaugment.augment_batch_dict(
        {k: jnp.asarray(batch[k]) for k in keys}, 128, jds.left_index,
        jds.right_index)
    ti, tm, ta = augment.augment_batch_dict(
        {k: torch.from_numpy(batch[k]) for k in keys}, 128, ds.left_index,
        ds.right_index)
    assert ti.dtype == torch.uint8 and ti.shape == (3, 128, 128, 3)
    assert np.abs(ti.numpy().astype(int)
                  - np.asarray(ji).astype(int)).max() <= 1
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-3)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-4)
    pi, pm, _ = augment.augment_batch_dict(
        {k: torch.from_numpy(batch[k]) for k in keys}, 128, ds.left_index,
        ds.right_index, warp_impl='patch')
    assert np.abs(ti.numpy().astype(int) - pi.numpy().astype(int)).max() <= 1


def test_augment_batch_refuses_unknown_warp():
    z = torch.zeros
    with pytest.raises(ValueError, match='warp_impl'):
        augment.augment_batch(
            z((1, 8, 8, 3), dtype=torch.uint8), z((1, 8, 8), dtype=torch.uint8),
            z((1, 1, 17, 4)), torch.eye(3)[None], torch.eye(3)[None, :2],
            torch.ones((1, 2)), z(1, dtype=torch.bool), z(1, dtype=torch.bool),
            z((1, 4)), torch.tensor([[8, 8]]), 8, [1], [2], warp_impl='gather')
