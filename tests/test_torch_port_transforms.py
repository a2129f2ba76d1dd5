"""The last public pieces of the JAX package's data layer, held against it
on the CPU: `blur` (cv2.GaussianBlur's uint8 values, bit for bit, fuzzed
over sizes down to 1x1, channel counts and sigmas), `jpeg_compression`
(the pixels and the random stream after it), `normalize_image`, the
combinators `compose`, `random_apply` and `multi_scale`,
`rescale_relative`, `square_pad`, `affine_keypoint_inverse` on a real
warp's meta, `ImageList` (JPEG with EXIF orientation, PNG, a missing
file), `skeleton_from_arrays`, `unpack_limbs` and `native.available`.
Also the digests `chip_smoke.py` `[transforms]` checks on the card's
host, which has no cv2: cv2's outputs on the same inputs."""
import sys
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / 'tests'))

import chip_smoke  # noqa: E402
from offsetguided_tpu.config import COCO_PERSON_SKELETON  # noqa: E402
from offsetguided_tpu.config import skeleton_from_arrays as jskeleton_arrays  # noqa: E402
from offsetguided_tpu.data import transforms as JT  # noqa: E402
from offsetguided_tpu.data.pipeline import ImageList as JImageList  # noqa: E402
from offsetguided_tpu.ops.decoder import unpack_limbs as junpack  # noqa: E402
from offsetguided_tpu_torch import config  # noqa: E402
from offsetguided_tpu_torch.data import native, pipeline, pixels  # noqa: E402
from offsetguided_tpu_torch.data import transforms as T  # noqa: E402
from offsetguided_tpu_torch.ops import decoder  # noqa: E402
from test_torch_port_codec import exif_app1  # noqa: E402

# the suite's worker processes share the host's cores
torch.set_num_threads(2)


def fuzz_blur(rng, sizes, channels, sigmas, n):
    for _ in range(n):
        h, w = sizes(rng)
        c = channels[rng.randint(len(channels))]
        shape = (h, w) if c == 0 else (h, w, c)
        img = rng.randint(0, 256, shape).astype(np.uint8)
        sigma = sigmas(rng)
        ours = pixels.gaussian_blur_u8(img, sigma)
        ref = cv2.GaussianBlur(img, (0, 0), sigma)
        assert ours.shape == ref.shape, (shape, sigma)
        assert np.array_equal(ours, ref), (shape, sigma)


def uniform_sigma(lo, hi):
    return lambda rng: lo + rng.rand() * (hi - lo)


@pytest.mark.parametrize('case', ['tiny', 'small', 'lines', 'channels',
                                  'sigmas', 'large'])
def test_blur_equals_cv2(case):
    """pixels.gaussian_blur_u8 against cv2.GaussianBlur(img, (0, 0), s):
    images narrower and shorter than the kernel (1x1 up, reflected more
    than once), single rows and columns (not filtered along their length
    1 axis), (H, W), (H, W, 1), 3 and 4 channels, sigmas from 0.05 (one
    tap) to 6 (37 taps) with the transform's 0.3-2.0 in between, and
    whole 480x640 images."""
    rng = np.random.RandomState(['tiny', 'small', 'lines', 'channels',
                                 'sigmas', 'large'].index(case))
    if case == 'tiny':
        fuzz_blur(rng, lambda r: r.randint(1, 9, 2), (0, 3),
                  uniform_sigma(0.3, 2.0), 400)
    elif case == 'small':
        fuzz_blur(rng, lambda r: r.randint(1, 48, 2), (0, 3),
                  uniform_sigma(0.3, 2.0), 400)
    elif case == 'lines':
        fuzz_blur(rng, lambda r: ((1, r.randint(1, 60)), (r.randint(1, 60), 1),
                                  (2, r.randint(1, 60)))[r.randint(3)],
                  (0, 1, 3), uniform_sigma(0.3, 2.0), 200)
    elif case == 'channels':
        fuzz_blur(rng, lambda r: r.randint(1, 30, 2), (0, 1, 3, 4),
                  uniform_sigma(0.3, 2.0), 300)
    elif case == 'sigmas':
        fixed = (0.05, 0.25, 0.3, 0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0, 3.0,
                 6.0)
        fuzz_blur(rng, lambda r: r.randint(1, 40, 2), (0, 3),
                  lambda r: fixed[r.randint(len(fixed))], 300)
    else:
        fuzz_blur(rng, lambda r: (480, 640), (0, 3),
                  uniform_sigma(0.3, 2.0), 6)


def test_blur_draws_as_jax():
    """`blur` draws its sigma as the JAX package's does and gives its
    pixels; the random streams stay equal."""
    img = chip_smoke.transform_image(61, 47, 3, seed=3)
    ours, ref = np.random.RandomState(5), np.random.RandomState(5)
    for max_sigma in (2.0, 1.0, 3.5):
        np.testing.assert_array_equal(T.blur(img, ours, max_sigma),
                                      JT.blur(img, ref, max_sigma))
    assert ours.rand() == ref.rand()


def test_kernel_size_and_weights():
    """The taps cv2 gives 8-bit images (cvRound(6 sigma + 1) | 1, half to
    even) and the fixed-point weights summing to 256, read from cv2 as the
    response to a unit impulse on a 1-row image (only the row pass runs:
    the output is the weight times 255 / 256, rounded)."""
    for sigma in (0.3, 0.25, 0.75, 1.0, 1.25, 1.6, 2.0):
        n = pixels.gaussian_ksize_u8(sigma)
        k = pixels.gaussian_kernel_q8(n, sigma)
        assert n % 2 == 1 and k.sum() == 256 and (k == k[::-1]).all()
        row = np.zeros((1, 2 * n + 1), np.uint8)
        row[0, n] = 255
        ref = cv2.GaussianBlur(row, (0, 0), sigma)[0, n - n // 2:n + n // 2 + 1]
        np.testing.assert_array_equal(ref, (k * 255 * 256 + (1 << 15)) >> 16)
    assert pixels.gaussian_ksize_u8(0.25) == 3      # 2.5 rounds to 2, | 1


def jpeg_inputs():
    rng = np.random.RandomState(4)
    return [chip_smoke.codec_image(480, 640, seed=7),
            chip_smoke.codec_image(97, 153, seed=1),
            rng.randint(0, 256, (5, 7, 3)).astype(np.uint8),
            rng.randint(0, 256, (1, 1, 3)).astype(np.uint8)]


@pytest.mark.parametrize('quality_range', [(50, 95), (95, 100), (1, 10)])
def test_jpeg_compression_equals_jax(quality_range):
    """The same quality drawn, cv2.imencode's stream and cv2.imdecode's
    pixels, and the same random state after each call."""
    ours, ref = np.random.RandomState(11), np.random.RandomState(11)
    for img in jpeg_inputs():
        a = T.jpeg_compression(img, ours, quality_range)
        b = JT.jpeg_compression(img, ref, quality_range)
        assert a.shape == b.shape and np.array_equal(a, b)
        np.testing.assert_array_equal(ours.get_state()[1],
                                      ref.get_state()[1])


def test_jpeg_compression_past_the_jpeg_limit_returns_the_input():
    """cv2.imencode fails on a side above 65500 and the JAX package then
    returns the image as it was: so does the port, after the same draw."""
    img = np.zeros((1, 65501, 3), np.uint8)
    ours, ref = np.random.RandomState(2), np.random.RandomState(2)
    assert T.jpeg_compression(img, ours) is img
    assert JT.jpeg_compression(img, ref) is img
    assert ours.rand() == ref.rand()


def test_normalize_image_equals_jax():
    img = chip_smoke.transform_image(33, 41, 3, seed=6)
    np.testing.assert_array_equal(T.normalize_image(img),
                                  JT.normalize_image(img))


def sample(seed=0):
    """A 97x153 scene with two persons, its meta, and a miss mask."""
    rng = np.random.RandomState(seed)
    img = chip_smoke.codec_image(97, 153, seed=seed)
    anns = np.zeros((2, 17, 4), np.float32)
    anns[:, :, 0] = rng.uniform(5, 148, (2, 17))
    anns[:, :, 1] = rng.uniform(5, 92, (2, 17))
    anns[:, :, 2] = rng.choice([0.0, 1.0, 2.0], (2, 17))
    anns[:, :, 3] = rng.uniform(1, 9, (2, 17))
    mask = (rng.rand(97, 153) < 0.5).astype(np.uint8) * 255
    return img, anns, T.make_meta(153, 97), mask


def assert_samples_equal(ours, ref):
    for a, b in zip(ours, ref):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]), err_msg=k)
        elif a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('factor', [0.5, 1.37, 2.0])
def test_rescale_relative_equals_jax(factor):
    """Through the port's resize, which repeats cv2's IPP cubic resize."""
    img, anns, meta, _ = sample(1)
    assert_samples_equal(T.rescale_relative(img, anns, meta, factor),
                         JT.rescale_relative(img, anns, meta, factor))


@pytest.mark.parametrize('shape', [(97, 153), (153, 97), (64, 64)])
def test_square_pad_equals_jax(shape):
    _, anns, _, _ = sample(2)
    img = chip_smoke.codec_image(*shape, seed=2)
    meta = T.make_meta(shape[1], shape[0])
    assert_samples_equal(T.square_pad(img, anns, meta),
                         JT.square_pad(img, anns, meta))


def shifted(dx):
    """A transform of the (image, anns, meta, mask) signature."""
    def f(image, anns, meta, mask_miss=None):
        anns = anns.copy()
        anns[:, :, 0] += dx
        return image, anns, dict(meta, dx=meta.get('dx', 0) + dx), mask_miss
    return f


def test_combinators_equal_jax():
    """`compose`, `random_apply` (one draw a call) and `multi_scale` chain
    and fan out as the JAX package's do, the random streams in step."""
    img, anns, meta, mask = sample(3)
    ours, ref = np.random.RandomState(9), np.random.RandomState(9)

    def build(M, rng):
        padded = M.compose(M.random_apply(shifted(1.0), 0.5, rng),
                           M.random_apply(shifted(10.0), 0.5, rng),
                           lambda i, a, m, k=None: M.square_pad(i, a, m) + (k,))
        return M.multi_scale(padded, M.compose(shifted(100.0)),
                             M.compose())
    fo, fr = build(T, ours), build(JT, ref)
    for _ in range(6):
        a, b = fo(img, anns, meta, mask), fr(img, anns, meta, mask)
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            assert_samples_equal(x, y)
    assert ours.rand() == ref.rand()


def test_affine_keypoint_inverse_on_a_warp_equals_jax():
    """A flipped, rotated, scaled warp (the host route's `warp_affine`) on
    both packages: the same meta, and the inverse maps the warped
    keypoints back to the originals, each in its own channel."""
    from offsetguided_tpu_torch.config.coco import LEFT_INDEX, RIGHT_INDEX
    img, anns, meta, mask = sample(4)
    params = dict(flip=True, rotate=17.0, scale=1.2, x_stretch=0.9,
                  y_stretch=1.1, x_offset=3, y_offset=-5)
    ours = T.warp_affine(img, anns, meta, mask, params, 128, LEFT_INDEX,
                         RIGHT_INDEX)
    ref = JT.warp_affine(img, anns, meta, mask, params, 128, LEFT_INDEX,
                         RIGHT_INDEX)
    assert_samples_equal(ours, ref)
    warped, wmeta = ours[1], ours[2]
    back = T.affine_keypoint_inverse(warped, wmeta)
    np.testing.assert_array_equal(back, JT.affine_keypoint_inverse(
        warped, ref[2]))
    np.testing.assert_allclose(back[:, :, :2], anns[:, :, :2], atol=1e-3)
    np.testing.assert_allclose(back[:, :, 3], anns[:, :, 3], rtol=1e-5)


def test_image_list_equals_jax(tmp_path):
    """JPEG with each EXIF orientation, PNG (RGB and grey), a .npy (which
    cv2.imread does not read) and a missing file: the same images and
    metas, and IOError where the JAX package raises it."""
    img = chip_smoke.codec_image(13, 21, seed=3)
    ok, body = cv2.imencode('.jpg', img[:, :, ::-1],
                            [int(cv2.IMWRITE_JPEG_QUALITY), 90])
    body = body.tobytes()
    paths = []
    for o in range(1, 9):
        paths.append(str(tmp_path / f'o{o}.jpg'))
        Path(paths[-1]).write_bytes(body[:2] + exif_app1(o, o % 2 == 0)
                                    + body[2:])
    for name, px in (('rgb.png', img[:, :, ::-1]), ('grey.png', img[:, :, 1])):
        paths.append(str(tmp_path / name))
        cv2.imwrite(paths[-1], px)
    ours, ref = pipeline.ImageList(paths), JImageList(paths)
    assert len(ours) == len(ref) == 10
    for i in range(len(paths)):
        a, b = ours.get(i), ref.get(i)
        assert a['meta'] == b['meta']
        assert a['image'].shape == b['image'].shape
        np.testing.assert_array_equal(a['image'], b['image'])
    np.save(tmp_path / 'x.npy', img)
    for bad in (str(tmp_path / 'x.npy'), str(tmp_path / 'missing.jpg')):
        for lst in (pipeline.ImageList([bad]), JImageList([bad])):
            with pytest.raises(IOError, match='missing image'):
                lst.get(0)


def test_transform_digests_are_cv2s(tmp_path):
    """`chip_smoke.transform_cases`, the port's outputs the card's host
    checks, against TRANSFORM_DIGESTS, and those against cv2's outputs on
    the same inputs (cv2.GaussianBlur, the JAX package's
    jpeg_compression, cv2.imread through its ImageList)."""
    ours = dict(chip_smoke.transform_cases(str(tmp_path)))
    assert list(ours) == list(chip_smoke.TRANSFORM_DIGESTS)
    ref = {}
    for i, (h, w) in enumerate(chip_smoke.BLUR_SIZES):
        for c in (1, 3):
            img = chip_smoke.transform_image(h, w, c, seed=i)
            for sigma in chip_smoke.BLUR_SIGMAS:
                ref[f'blur {h}x{w}x{c} sigma {sigma}'] = cv2.GaussianBlur(
                    img, (0, 0), sigma)
    ref['jpeg_compression 480x640 seed 0'] = JT.jpeg_compression(
        chip_smoke.codec_image(480, 640, seed=7), np.random.RandomState(0))
    names, paths = zip(*chip_smoke.transform_files(str(tmp_path)))
    images = JImageList(paths)
    ref.update((name, images.get(i)['image']) for i, name in enumerate(names))
    for name, want in chip_smoke.TRANSFORM_DIGESTS.items():
        assert chip_smoke.pixel_digest(ref[name]) == want, name
        assert chip_smoke.pixel_digest(ours[name]) == want, name


def test_skeleton_from_arrays_equals_jax():
    for sk in (COCO_PERSON_SKELETON, config.CROWDPOSE_PERSON_SKELETON):
        for a, b in zip(config.skeleton_from_arrays(sk),
                        jskeleton_arrays(sk)):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def test_unpack_limbs_inverts_pack_limbs():
    """The port's `unpack_limbs` gives the JAX package's fields (indices
    as int64, the port's `Limbs` type) and `pack_limbs` packs them back."""
    rng = np.random.RandomState(7)
    packed = rng.uniform(-50, 600, (2, 19, 5, 13)).astype(np.float32)
    packed[..., 6:8] = rng.randint(0, 2_000_000, (2, 19, 5, 2))
    ours = decoder.unpack_limbs(packed)
    ref = junpack(jnp.asarray(packed))
    assert ours._fields == ref._fields
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ours.ind_f.dtype == torch.int64
    assert torch.equal(decoder.pack_limbs(ours), torch.from_numpy(packed))


def test_native_decoder_available():
    """The C RLE decoder builds and loads here (a failed build raises)."""
    assert native.available() is True
