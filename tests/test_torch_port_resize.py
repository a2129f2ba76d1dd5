"""The port's cubic resize (`data/pixels.py::resize_cubic_u8`, the numpy
definition, and `resize_cubic_u8_native`, its C++ twin in
`csrc/host_warp.cpp`) against what the JAX package resizes with,
`cv2.resize(..., interpolation=INTER_CUBIC)`: value for value for sources
of at least 4 x 4 (OpenCV 5.0 hands those to Intel IPP), down and up, one
and three channels; within one grey level below that, where cv2 uses its
own fixed-point resize."""
import cv2
import numpy as np
import pytest

from offsetguided_tpu_torch.data import pixels
from offsetguided_tpu_torch.data import transforms as T

# (h, w) -> (out_h, out_w): the self-check's long-edge rescale (320 -> 128,
# factor 2.5) and fixed-height halving, COCO-sized long-edge rescales both
# ways, upscales, a near-identity and odd sizes
SHAPES = [((256, 320), (102, 128)), ((256, 320), (128, 160)),
          ((480, 640), (384, 512)), ((640, 427), (512, 341)),
          ((90, 130), (443, 640)), ((37, 53), (357, 512)),
          ((511, 511), (512, 512)), ((4, 4), (42, 64)), ((5, 9), (2, 3)),
          ((333, 517), (82, 128))]


def both(img, ow, oh):
    return (pixels.resize_cubic_u8(img, ow, oh),
            pixels.resize_cubic_u8_native(img, ow, oh))


@pytest.mark.parametrize('src,out', SHAPES)
def test_resize_matches_cv2(src, out):
    """Noise in (H, W, 3), (H, W, 1) and (H, W): both versions equal to
    cv2, value for value."""
    rng = np.random.RandomState(src[0] * 7 + out[1])
    (h, w), (oh, ow) = src, out
    for shape in ((h, w, 3), (h, w, 1), (h, w)):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        ref = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_CUBIC)
        for got in both(img, ow, oh):
            assert got.shape == shape[:0] + (oh, ow) + shape[2:]
            np.testing.assert_array_equal(got.reshape(ref.shape), ref)


def test_resize_fuzz_matches_cv2():
    """40 draws of sizes 4-160 a side, factors 1/8-8, one or three
    channels, noise or a smooth ramp (whose values sit near halves less
    often than noise's): equal to cv2, and the C++ equal to numpy."""
    rng = np.random.RandomState(0)
    for _ in range(40):
        h, w = rng.randint(4, 161, 2)
        oh, ow = (max(1, int(v * 2.0 ** rng.uniform(-3, 3))) for v in (h, w))
        c = int(rng.choice([1, 3]))
        if rng.rand() < 0.5:
            img = rng.randint(0, 256, (h, w, c)).astype(np.uint8)
        else:
            yy, xx = np.mgrid[0:h, 0:w]
            ramp = (xx * rng.uniform(0.2, 3) + yy * rng.uniform(0.2, 3))
            img = np.repeat((ramp % 256).astype(np.uint8)[..., None], c, 2)
        ref = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_CUBIC)
        ours, native = both(img, ow, oh)
        np.testing.assert_array_equal(ours.reshape(ref.shape), ref,
                                      err_msg=f'{(h, w, c)} -> {(oh, ow)}')
        np.testing.assert_array_equal(native, ours)


def test_eval_rescale_equals_cv2():
    """`transforms.rescale_long_absolute` / `rescale_high_absolute` (the
    evaluation's and the server's rescale) give cv2's pixels."""
    img = np.random.RandomState(1).randint(0, 256, (256, 320, 3),
                                           np.uint8)
    meta = T.make_meta(320, 256)
    anns = np.zeros((0, 17, 4), np.float32)
    for fn, (oh, ow) in ((T.rescale_long_absolute, (102, 128)),
                         (T.rescale_high_absolute, (128, 160))):
        got, _, m = fn(img, anns, meta, 128)
        np.testing.assert_array_equal(got, cv2.resize(
            img, (ow, oh), interpolation=cv2.INTER_CUBIC))
        np.testing.assert_array_equal(m['width_height'], (ow, oh))


@pytest.mark.parametrize('src', [(2, 3), (3, 64), (64, 3), (1, 8)])
def test_small_sources_within_one_grey_level(src):
    """Under 4 pixels a side cv2 resizes in its own fixed point, which
    the port does not repeat: within one grey level of it, and the C++
    equal to numpy."""
    img = np.random.RandomState(2).randint(0, 256, src + (3,), np.uint8)
    ref = cv2.resize(img, (64, 42), interpolation=cv2.INTER_CUBIC)
    ours, native = both(img, 64, 42)
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1
    np.testing.assert_array_equal(native, ours)


def test_resize_refuses_other_channel_counts():
    img = np.zeros((8, 8, 4), np.uint8)
    for fn in (pixels.resize_cubic_u8, pixels.resize_cubic_u8_native):
        with pytest.raises(ValueError, match='uint8'):
            fn(img, 4, 4)
