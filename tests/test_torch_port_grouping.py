"""The plain version of the port's grouping kernel equals the JAX grouping
(`group_skeletons`, XLA) and the Pallas kernel in interpret mode: counts
exact, scores within atol 1e-5, poses within atol 1e-4 (the tolerances of
tests/test_grouping_pallas.py)."""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offsetguided_tpu.config import COCO_PERSON_SKELETON
from offsetguided_tpu.config.defaults import DecoderConfig as JDecoderConfig
from offsetguided_tpu.ops.grouping import group_skeletons as jgroup
from offsetguided_tpu.ops.pallas.grouping_pallas import group_skeletons_pallas
from offsetguided_tpu_torch.config.defaults import DecoderConfig
from offsetguided_tpu_torch.ops.cuda import grouping

sys.path.insert(0, __file__.rsplit('/', 1)[0])
from test_grouping import make_person_limbs  # noqa: E402

SK = COCO_PERSON_SKELETON
CFG = dict(person_thre=0.06, dist_max=20.0, use_scale=True, max_poses=8)


def make_batch(rng, n=2, K=10):
    ls = [make_person_limbs(rng, 1 + t % 4, K=K, noise=3)[0]
          for t in range(n)]
    return np.stack(ls).astype(np.float32)


def sentinel_batch(rng):
    """The inputs of tests/test_grouping_pallas.py: +inf off-image rows,
    NaN rows from opposing flip sentinels, one NaN scale, and keypoint
    indices lifted to full-resolution magnitude."""
    batch = make_batch(rng, 2).astype(np.float64)
    batch[..., 6:8] += 2_500_000.0
    off = batch[..., 0] < -9000.0
    for c in (0, 1, 8):
        batch[..., c] = np.where(off, np.inf, batch[..., c])
    batch[:, ::3, -1, :] = np.nan
    batch[:, 1, 0, 12] = np.nan
    return batch.astype(np.float32)


def compare(batch, cfg_kw, pallas=True):
    cfg = DecoderConfig(**cfg_kw)
    ours = grouping.group_skeletons(torch.from_numpy(batch), SK, cfg,
                                    capacity=cfg.capacity)
    jcfg = JDecoderConfig(**cfg_kw)
    refs = [jgroup(jnp.asarray(batch), SK, jcfg, capacity=cfg.capacity)]
    if pallas:
        refs.append(group_skeletons_pallas(
            jnp.asarray(batch), SK, jcfg, capacity=cfg.capacity,
            interpret=True))
    p, s, c = (t.numpy() for t in ours)
    for rp, rs, rc in refs:
        np.testing.assert_array_equal(c, np.asarray(rc))
        np.testing.assert_allclose(s, np.asarray(rs), atol=1e-5)
        np.testing.assert_allclose(p, np.asarray(rp), atol=1e-4)
    return c


def test_matches_jax_and_pallas(rng):
    c = compare(make_batch(rng, 2), CFG)
    assert c.sum() > 0


def test_inf_nan_sentinels_and_fullres_indices(rng):
    compare(sentinel_batch(rng), CFG)


@pytest.mark.parametrize('n_persons,noise,use_scale,sort_dim', [
    (1, 0, True, 2), (3, 4, True, 2), (5, 6, False, 4), (8, 2, True, 2),
])
def test_person_scenes_match_jax(n_persons, noise, use_scale, sort_dim):
    rng = np.random.RandomState(10 + n_persons)
    limbs = np.stack([make_person_limbs(rng, n_persons, K=12, noise=noise)[0]
                      for _ in range(3)]).astype(np.float32)
    cfg = dict(person_thre=0.06, dist_max=20.0, use_scale=use_scale,
               sort_dim=sort_dim, max_poses=12)
    c = compare(limbs, cfg, pallas=False)
    assert c.min() >= min(n_persons, 1)


def test_capacity_overflow_matches_jax():
    """More new skeletons than free rows: the lowest-ranked are dropped."""
    rng = np.random.RandomState(21)
    limbs = make_person_limbs(rng, 12, K=12, noise=0)[0][None]
    compare(limbs.astype(np.float32), dict(CFG, capacity=8, max_poses=8),
            pallas=False)
