"""The port's mask rendering against the JAX package's: RLE decoding, the
polygon fill (the JAX package calls cv2.fillPoly; the port fills in numpy),
the miss masks of the hard set, and the stride downscale of a mask. Every
comparison is exact: masks are integer pictures."""
import numpy as np
import pytest
import torch

from offsetguided_tpu.config.defaults import EncoderConfig as JEncoderConfig
from offsetguided_tpu.data import coco as jcoco
from offsetguided_tpu.ops.encoder import downscale_mask as jdownscale_mask
from offsetguided_tpu_torch.config.defaults import EncoderConfig
from offsetguided_tpu_torch.data import coco
from offsetguided_tpu_torch.data.synthetic import hard_annotations
from offsetguided_tpu_torch.ops.encoder import downscale_mask
from test_data import rle_encode_counts

# the suite's worker processes share the host's cores
torch.set_num_threads(2)


def random_runs(rng, h, w):
    mask = (rng.rand(h, w) > rng.uniform(0.2, 0.8)).astype(np.uint8)
    flat = mask.T.reshape(-1)
    edges = np.flatnonzero(np.diff(flat)) + 1
    bounds = np.concatenate([[0], edges, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat[0] == 1:
        counts = [0] + counts
    return mask, counts


def test_native_rle_codec_matches_jax_and_the_plain_decoder():
    """`csrc/rle.cpp` through `data/native.py` on 200 random masks: the
    compressed string decodes to the mask, as JAX's native decoder and
    the port's Python decoder give it, and the mask encodes to JAX's
    column-major runs."""
    from offsetguided_tpu.data import native as jnative
    from offsetguided_tpu_torch.data import native
    rng = np.random.RandomState(2)
    for _ in range(200):
        h, w = rng.randint(1, 60), rng.randint(1, 60)
        mask, counts = random_runs(rng, h, w)
        s = rle_encode_counts(counts)
        ours = native.rle_string_to_mask(s, h, w)
        np.testing.assert_array_equal(ours, mask)
        np.testing.assert_array_equal(ours, jnative.rle_string_to_mask(
            s, h, w))
        np.testing.assert_array_equal(ours, coco.runs_to_mask(
            coco.rle_decode_counts(s), h, w))
        np.testing.assert_array_equal(native.rle_encode_mask(mask),
                                      jnative.rle_encode_mask(mask))


# (counts string, h, w): cut inside a word, runs past the mask, negative
# runs, characters outside the alphabet, more runs than pixels (the C
# decoder refuses: the Python decoder takes over), a character beyond ASCII
MALFORMED = [
    (rle_encode_counts([3, 4, 5]) + chr(48 + 0x20), 4, 4),
    (rle_encode_counts([5, 100, 3]), 4, 5),
    (rle_encode_counts([3, -2, 4, 6]), 4, 4),
    (rle_encode_counts([2, 3]) + ' ~0', 3, 3),
    ('!#%&0', 2, 3),
    ('1111111', 1, 1),
    (rle_encode_counts([2, 2]) + '\xe9', 2, 2),
]


def outcome(fn):
    try:
        return fn()
    except Exception as e:                          # noqa: BLE001
        return type(e)


@pytest.mark.parametrize('case', range(len(MALFORMED)))
def test_malformed_rle_strings_decode_as_jax(case):
    """Each malformed string gives what the JAX package's `rle_to_mask`
    gives: the same mask, or the same exception."""
    s, h, w = MALFORMED[case]
    rle = {'size': [h, w], 'counts': s}
    ours, theirs = (outcome(lambda: coco.rle_to_mask(rle)),
                    outcome(lambda: jcoco.rle_to_mask(rle)))
    if isinstance(theirs, np.ndarray):
        np.testing.assert_array_equal(ours, theirs)
    else:
        assert ours is theirs


def test_failed_rle_build_raises(tmp_path, monkeypatch):
    """A C++ source that does not compile raises; no silent fallback."""
    from offsetguided_tpu_torch.ops.cuda import _build
    (tmp_path / 'rle.cpp').write_text('not C++\n')
    monkeypatch.setattr(_build, 'CSRC', tmp_path)
    monkeypatch.setattr(_build, 'BUILD', tmp_path / 'build')
    monkeypatch.delitem(_build._libs, 'rle', raising=False)
    with pytest.raises(RuntimeError, match='rle.cpp'):
        coco.rle_to_mask({'size': [2, 2], 'counts': '04'})


def test_rle_decoding_matches_jax():
    """Compressed strings and plain count lists of random masks decode to
    the same masks on both sides (the JAX side through its native codec
    where it builds)."""
    rng = np.random.RandomState(0)
    for _ in range(20):
        h, w = rng.randint(1, 40), rng.randint(1, 40)
        mask, counts = random_runs(rng, h, w)
        s = rle_encode_counts(counts)
        assert coco.rle_decode_counts(s) == jcoco.rle_decode_counts(s)
        for c in (s, counts):
            ours = coco.rle_to_mask({'size': [h, w], 'counts': c})
            np.testing.assert_array_equal(ours, mask)
            np.testing.assert_array_equal(
                ours, jcoco.rle_to_mask({'size': [h, w], 'counts': c}))


def polygon_cases(rng):
    """(parts, h, w): non-integer vertices (rounded half to even),
    concave and self-intersecting polygons, parts that overlap and touch,
    vertices on the far border (x = w, y = h, as COCO's float coordinates
    round to), and vertices far out of the frame."""
    cases = []
    for trial in range(400):
        h, w = rng.randint(5, 48), rng.randint(5, 48)
        kind = trial % 4
        parts = []
        for _ in range(rng.randint(1, 4)):
            n = rng.randint(3, 9)
            if kind == 0:                            # in the frame, floats
                pts = np.stack([rng.uniform(0, w, n), rng.uniform(0, h, n)], 1)
            elif kind == 1:                          # touching the borders
                pts = np.stack([rng.randint(0, w + 1, n),
                                rng.randint(0, h + 1, n)], 1) + \
                    rng.choice([0.0, 0.5], (n, 2))
            elif kind == 2:                          # crossing the frame
                pts = np.stack([rng.uniform(-0.3 * w, 1.3 * w, n),
                                rng.uniform(-0.3 * h, 1.3 * h, n)], 1)
            else:                                    # mostly outside
                pts = np.stack([rng.uniform(-3 * w, 3 * w, n),
                                rng.uniform(-3 * h, 3 * h, n)], 1)
            parts.append(pts.reshape(-1).tolist())
        cases.append((parts, h, w))
    # hand-made: a self-touching bow tie, a concave comb, a square ring of
    # two parts, and a part with fewer than 3 vertices (ignored)
    cases += [
        ([[2, 2, 12, 12, 12, 2, 2, 12]], 14, 14),
        ([[1, 1, 15, 1, 15, 12, 12, 3, 9, 12, 6, 3, 3, 12, 1, 12]], 14, 17),
        ([[1, 1, 13, 1, 13, 13, 1, 13], [4, 4, 10, 4, 10, 10, 4, 10]], 15, 15),
        ([[3.5, 2.5, 7.5, 2.5, 5.5, 8.5], [1, 1, 4, 4]], 10, 10),
    ]
    return cases


def test_polygon_fill_matches_cv2():
    """`polygons_to_mask` gives cv2.fillPoly's pixel set (the JAX package's
    function) on every case, boundary pixels included."""
    rng = np.random.RandomState(1)
    bad = []
    for parts, h, w in polygon_cases(rng):
        ours = coco.polygons_to_mask(parts, h, w)
        ref = jcoco.polygons_to_mask(parts, h, w)
        assert ours.dtype == np.uint8 and ours.shape == (h, w)
        if not np.array_equal(ours, ref):
            bad.append((parts, h, w, int((ours != ref).sum())))
    assert not bad, bad[:3]


def test_miss_masks_of_the_hard_set_match_jax():
    """build_miss_masks (polygons, crowd regions, keypoint-less persons)
    on the hard set's annotations: identical mask_miss and mask_all."""
    ds = hard_annotations(12, seed=2, ext='npy')
    by_image = {}
    for a in ds['annotations']:
        by_image.setdefault(a['image_id'], []).append(a)
    n_crowd = 0
    for info in ds['images']:
        anns = by_image.get(info['id'], [])
        n_crowd += sum(a.get('iscrowd', 0) for a in anns)
        ours = coco.build_miss_masks(anns, info['height'], info['width'])
        ref = jcoco.build_miss_masks(anns, info['height'], info['width'])
        for o, r in zip(ours, ref):
            np.testing.assert_array_equal(o, r)
    assert n_crowd > 0


@pytest.mark.parametrize('kind', ['uint8', 'float'])
def test_downscale_mask_matches_jax(kind):
    """Bool for bool, on 0/255 uint8 masks and on [0, 1] float masks (the
    device warp's output), at strides 4 and 8."""
    rng = np.random.RandomState(3)
    base = rng.rand(3, 64, 96) > 0.5
    # blobs, so the cubic filter lands near the threshold often
    base[:, 10:30, 20:50] = True
    if kind == 'uint8':
        x = base.astype(np.uint8) * 255
    else:
        x = np.clip(base + 0.3 * rng.randn(*base.shape), 0, 1).astype(
            np.float32)
    for stride in (4, 8):
        ours = downscale_mask(torch.from_numpy(x), EncoderConfig(stride=stride))
        ref = np.asarray(jdownscale_mask(x, JEncoderConfig(stride=stride)))
        assert ours.dtype == torch.bool and ours.shape == ref.shape
        np.testing.assert_array_equal(ours.numpy(), ref)
