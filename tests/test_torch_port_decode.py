"""The port's decoder equals the JAX PostProcessor on identical prediction
maps: the packed (N, L, K, 13) limbs (index columns 6-7 exact) and the
grouped poses, with flip-test off, on, and with `cat_flip_offs`, on every
decode route: square maps (fused peaks), rectangular maps and a 5x5 NMS
(upsample + block top-k), stride resolution with and without jitter, and
`scored_offset`."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offsetguided_tpu.config import COCO_PERSON_SIGMAS, COCO_PERSON_SKELETON
from offsetguided_tpu.config.defaults import DecoderConfig as JDecoderConfig
from offsetguided_tpu.config.defaults import EncoderConfig
from offsetguided_tpu.decoder import PostProcessor as JPostProcessor
from offsetguided_tpu.ops.encoder import encode_targets
from offsetguided_tpu.ops.grouping import group_skeletons as jgroup_skeletons
from offsetguided_tpu_torch.config.defaults import DecoderConfig
from offsetguided_tpu_torch.decoder import PostProcessor
from offsetguided_tpu_torch.ops import decoder as dec

# the suite's worker processes share the host's cores
torch.set_num_threads(2)

IMG = 128
TEMPLATE = np.array([
    [0.50, 0.07], [0.46, 0.05], [0.54, 0.05], [0.42, 0.07], [0.58, 0.07],
    [0.36, 0.22], [0.64, 0.22], [0.32, 0.40], [0.68, 0.40], [0.30, 0.57],
    [0.70, 0.57], [0.41, 0.54], [0.59, 0.54], [0.40, 0.75], [0.60, 0.75],
    [0.39, 0.95], [0.61, 0.95]], dtype=np.float32)


def scene_maps(n, seed=0, w=IMG):
    """Ground-truth maps of random stick-figure scenes (IMG x w pixels) as
    predictions, with noise on the heatmaps; background offsets stay +inf
    and background scales NaN, the sentinels the decoder must carry."""
    rng = np.random.RandomState(seed)
    anns = np.zeros((n, 3, 17, 4), np.float32)
    for i in range(n):
        for p in range(1 + i % 3):
            box = rng.uniform(40, 70)
            x0, y0 = rng.uniform(0, w - box), rng.uniform(0, IMG - box)
            anns[i, p, :, 0] = x0 + TEMPLATE[:, 0] * box + rng.rand(17)
            anns[i, p, :, 1] = y0 + TEMPLATE[:, 1] * box + rng.rand(17)
            anns[i, p, :, 2] = 2.0
            anns[i, p, :, 3] = box * np.asarray(COCO_PERSON_SIGMAS)
    t = encode_targets(jnp.asarray(anns), np.asarray(COCO_PERSON_SIGMAS),
                       COCO_PERSON_SKELETON, IMG // 4, w // 4,
                       EncoderConfig(max_persons=3))
    hmp = np.asarray(t.hmp) + 0.02 * rng.rand(*t.hmp.shape).astype(np.float32)
    return {'hmp': hmp.astype(np.float32), 'jomp': np.asarray(t.jomp),
            'omp': np.asarray(t.omp), 'scmp': np.asarray(t.scmp) * 0.1}


def random_maps(n, seed=0, quantized=False):
    rng = np.random.RandomState(seed)
    h = IMG // 4
    hmp = rng.rand(n, h, h, 17).astype(np.float32) ** 3
    if quantized:                       # ties in the peak selection
        hmp = (np.round(hmp * 8) / 8).astype(np.float32)
    return {'hmp': hmp,
            'jomp': (rng.randn(n, h, h, 2) * 0.5).astype(np.float32),
            'omp': (rng.randn(n, h, h, 38) * 4).astype(np.float32),
            'scmp': (rng.rand(n, h, h, 17) * 8).astype(np.float32)}


def both(maps, **kw):
    kw = dict(dict(topk=12, thre_hmp=0.05, dist_max=40.0), **kw)
    jpreds = {k: [jnp.asarray(v)] for k, v in maps.items()}
    jpreds.update(bg=[None], spread=[None])
    preds = {k: [torch.from_numpy(np.array(v))] for k, v in maps.items()}
    return (JPostProcessor(cfg=JDecoderConfig(**kw)), jpreds,
            PostProcessor(cfg=DecoderConfig(**kw)), preds)


GROUP_KW = dict(topk=12, thre_hmp=0.05, dist_max=40.0, person_thre=0.05)


@functools.lru_cache(maxsize=None)
def jax_grouping():
    """The JAX package's grouping, jitted once for every route: the routes
    differ only in the decode fields, which grouping does not read."""
    return jax.jit(functools.partial(
        jgroup_skeletons, skeleton=tuple(COCO_PERSON_SKELETON),
        cfg=JDecoderConfig(**GROUP_KW)))


MAPS = {'scene': lambda n: scene_maps(n),
        'random': lambda n: random_maps(n, 1),
        'ties': lambda n: random_maps(n, 2, quantized=True)}
FLIPS = {'noflip': (False, {}), 'flip': (True, {}),
         'catflip': (True, dict(cat_flip_offs=True))}


@pytest.mark.parametrize('flip', sorted(FLIPS))
@pytest.mark.parametrize('maps', sorted(MAPS))
def test_packed_limbs_match_jax(maps, flip):
    flip_test, kw = FLIPS[flip]
    jpp, jpreds, pp, preds = both(MAPS[maps](4 if flip_test else 2), **kw)
    ref = np.asarray(jpp.decode_packed_limbs(jpreds, flip_test))
    ours = pp.decode_packed_limbs(preds, flip_test).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours[..., 6:8], ref[..., 6:8])
    # the interpolation weights and limb scores are summed in another order
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('flip', sorted(FLIPS))
def test_decoded_poses_match_jax(flip):
    flip_test, kw = FLIPS[flip]
    jpp, jpreds, pp, preds = both(scene_maps(4 if flip_test else 2, 3),
                                  person_thre=0.05, **kw)
    ref = jpp.decode_packed_limbs(jpreds, flip_test)
    rp, rs, rc = (np.asarray(a) for a in jax_grouping()(ref))
    p, s, c = (t.numpy() for t in pp.decode_body(preds, flip_test))
    np.testing.assert_array_equal(c, rc)
    assert c.sum() > 0
    np.testing.assert_allclose(s, rs, atol=1e-5)
    np.testing.assert_allclose(p, rp, atol=1e-3)


def test_sample_limb_maps_poisons_nonfinite_footprint():
    """A sample is +inf when any tap cell is not finite, even at zero
    weight; other samples keep their value."""
    maps = torch.ones(1, 6, 6, 2)
    maps[0, 2, 2, 1] = float('nan')
    xs = torch.tensor([[[9, 23]]])       # the first reads cell (2, 2)
    ys = torch.tensor([[[9, 23]]])
    out = dec.sample_limb_maps(maps, None, xs, ys, 4, 'bicubic')
    assert out[0, 0, 0, 0] == 1.0 and torch.isinf(out[0, 0, 0, 1])
    assert torch.all(out[0, 0, 1] == 1.0)


def test_sample_limb_maps_refuses_nearest():
    """Both sides raise on 'nearest', which has no sampled-gather form."""
    from offsetguided_tpu.ops.decoder import sample_limb_maps as jsample
    maps = np.random.RandomState(0).rand(1, 6, 6, 2).astype(np.float32)
    xs = np.array([[[5, 9]]], np.int32)
    ys = np.array([[[6, 10]]], np.int32)
    with pytest.raises(ValueError):
        jsample(jnp.asarray(maps), None, jnp.asarray(xs), jnp.asarray(ys), 4,
                'nearest')
    with pytest.raises(ValueError):
        dec.sample_limb_maps(torch.from_numpy(maps), None,
                             torch.from_numpy(xs), torch.from_numpy(ys), 4,
                             'nearest')


def test_decode_with_scales_refuses_nearest():
    """A decode that samples the scale head at resize_mode='nearest' raises
    on both sides instead of returning misplaced scales."""
    jpp, jpreds, pp, preds = both(scene_maps(1, 4), resize_mode='nearest')
    with pytest.raises(ValueError):
        jpp.decode_packed_limbs(jpreds)
    with pytest.raises(ValueError):
        pp.decode_packed_limbs(preds)


# decode routes past the fused peaks kernel: (map width, DecoderConfig);
# flip-test runs on one route of each decode resolution
ROUTES = {
    'rect': (IMG + 64, {}),
    'nms5': (IMG, dict(nms_kernel=5)),
    'lowres': (IMG, dict(upsampled_decode=False)),
    'lowres_nojitter': (IMG, dict(upsampled_decode=False,
                                  use_jitter_offset=False)),
    'scored_offset': (IMG + 32, dict(scored_offset=True)),
}
ROUTE_CASES = [(r, False) for r in sorted(ROUTES)] + [('rect', True),
                                                      ('lowres', True)]
@pytest.mark.parametrize('route,flip_test', ROUTE_CASES)
def test_decode_routes_match_jax(route, flip_test):
    w, kw = ROUTES[route]
    maps = scene_maps(4 if flip_test else 2, 5, w=w)
    jpp, jpreds, pp, preds = both(maps, person_thre=0.05, **kw)
    ref = np.asarray(jpp.decode_packed_limbs(jpreds, flip_test))
    ours = pp.decode_packed_limbs(preds, flip_test).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours[..., 6:8], ref[..., 6:8])
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)
    # JAX's decode is grouping of its packed limbs (PostProcessor._decode_body)
    rp, rs, rc = (np.asarray(a) for a in jax_grouping()(jnp.asarray(ref)))
    p, s, c = (t.numpy() for t in pp.decode_body(preds, flip_test))
    np.testing.assert_array_equal(c, rc)
    assert c.sum() > 0
    np.testing.assert_allclose(s, rs, atol=1e-5)
    np.testing.assert_allclose(p, rp, atol=1e-3)


def test_postprocessor_rejects_what_the_kernels_do_not_compute():
    """The peaks kernel upsamples x4; another stride raises at construction
    instead of decoding wrongly."""
    with pytest.raises(NotImplementedError):
        PostProcessor(cfg=DecoderConfig(stride=8))
