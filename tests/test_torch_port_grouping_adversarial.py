"""The port's plain grouping against the JAX grouping (`group_skeletons`,
XLA) on the inputs of tests/test_grouping_adversarial.py and
tests/test_grouping_overflow.py: merge chains settled and not, the
equal-score dedup tie, the extension tie, the ten-trial tie-prone fuzz
(J = 7) and the crowd at 40 / 64, 78 / 64 and 78 / 128 rows, top-k 96.
Counts exact; pose sets matched as those tests match them, at atol 1e-4.

`max_poses` above the capacity (96 rows out of 64, 40 out of 16): the
port's output has `max_poses` rows on every device, as the TPU kernel's
has. Its first min(capacity, max_poses) rows equal the XLA grouping's
(which returns only those), the rest are zeros, and all of them equal the
Pallas kernel's in interpret mode.

The inputs come from `chip_smoke.py`, which rebuilds them without JAX for
the card (`[grouping]` there and tests/test_torch_port_gpu.py); the first
test holds those functions equal to the JAX tests' own. Also here: the
grouping kernel's shared-memory limit, checked in Python before a launch.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / 'tests'))

import chip_smoke  # noqa: E402
from offsetguided_tpu.config.defaults import DecoderConfig as JDecoderConfig  # noqa: E402
from offsetguided_tpu.ops.grouping import group_skeletons as jgroup  # noqa: E402
from offsetguided_tpu.ops.pallas.grouping_pallas import (  # noqa: E402
    group_skeletons_pallas)
from offsetguided_tpu_torch.config.defaults import DecoderConfig  # noqa: E402
from offsetguided_tpu_torch.ops.cuda import grouping  # noqa: E402
from test_grouping_adversarial import (  # noqa: E402
    _match_pose_sets, chain_limbs, conn, empty_limbs)
from test_grouping_overflow import make_crowd  # noqa: E402

# the suite's worker processes share the host's cores
torch.set_num_threads(2)

CASES = ['chain', 'chain_no_settle', 'equal_tie', 'extension_tie', 'fuzz',
         'crowd_40_64', 'crowd_78_64', 'crowd_78_128']


def test_inputs_equal_the_jax_tests():
    assert CASES == list(chip_smoke.adversarial_cases())
    np.testing.assert_array_equal(chip_smoke.chain_limbs(), chain_limbs())
    np.testing.assert_array_equal(chip_smoke.empty_limbs(3, 5),
                                  empty_limbs(3, 5))
    assert chip_smoke.conn(*range(11)) == conn(*range(11))
    for n in (40, 78):
        np.testing.assert_array_equal(chip_smoke.make_crowd(n),
                                      np.asarray(make_crowd(n)))


@pytest.mark.parametrize('name', CASES)
def test_adversarial_inputs_match_jax(name):
    x, sk, j, kw = chip_smoke.adversarial_cases()[name]
    ours = grouping.group_skeletons(torch.from_numpy(x), sk,
                                    DecoderConfig(**kw), j, kw['capacity'])
    ref = jgroup(jnp.asarray(x), sk, JDecoderConfig(**kw), n_keypoints=j,
                 capacity=kw['capacity'])
    (p, s, c), (rp, rs, rc) = ((np.asarray(t) for t in o) for o in (ours, ref))
    rows = min(kw['capacity'], kw['max_poses'])
    assert p.shape[1] == s.shape[1] == kw['max_poses'] and rp.shape[1] == rows
    assert not p[:, rows:].any() and not s[:, rows:].any()
    np.testing.assert_array_equal(c, rc)
    np.testing.assert_allclose(np.sort(s[:, :rows], axis=1),
                               np.sort(rs, axis=1), atol=1e-5)
    for i, n in enumerate(c):
        _match_pose_sets(p[i, :n], rp[i, :n], int(n))
    if name.startswith('crowd'):
        valid, cap = (int(v) for v in name.split('_')[1:])
        assert int(c[0]) == min(valid, cap)


@pytest.mark.parametrize('K,M,fits', [(32, 64, True), (96, 128, True),
                                      (48, 256, True), (32, 464, True),
                                      (32, 465, False), (96, 512, False)])
def test_shared_memory_limit(K, M, fits):
    """The kernel's shared bytes, computed in Python as `smem_bytes` in
    csrc/grouping.cu computes them: capacity 128 at top-k 96 and capacity
    256 at the default top-k 48 fit in 227 KB; capacity 465 at top-k 32 is
    the first that does not, and raises naming the shapes."""
    need = grouping.smem_bytes(K, 17, M, 19)
    assert need == 4 * (M * 17 * 6 + M * 17 + 2 * K * 13 + 38 + 4 * M
                        + 2 * K + 32 * ((K + 31) // 32))
    assert (need <= grouping.MAX_SMEM) == fits
    if fits:
        grouping.check_shapes(K, 17, M, 19, 40, 2)
    else:
        with pytest.raises(ValueError, match=f'capacity {M}, top-k {K}'):
            grouping.check_shapes(K, 17, M, 19, 40, 2)


def over_capacity_cases():
    """name -> (packed limbs, skeleton, DecoderConfig keywords): JAX's
    overflow input at capacity 64 with max_poses 96, and a crowd of two
    images at capacity 16 with max_poses 40 (every limb's candidates
    collide, so each image fills its 16 rows)."""
    return {
        '64_96': (chip_smoke.make_crowd(78), chip_smoke.CROWD_SK,
                  chip_smoke.crowd_cfg(64)),
        '16_40': (chip_smoke.crowd_limbs(2, 24, seed=5), chip_smoke.CROWD_SK,
                  dict(topk=24, dist_max=40.0, use_scale=False,
                       person_thre=0.05, max_poses=40, capacity=16)),
    }


@pytest.mark.parametrize('name', ['64_96', '16_40'])
def test_max_poses_over_capacity_matches_jax(name):
    """max_poses above the capacity, which the kernel once refused: the
    op's CPU output has max_poses rows, as its fake declares; the first
    min(capacity, max_poses) equal JAX's XLA grouping, the rest are zeros
    with score 0, and every row equals JAX's Pallas kernel (interpret
    mode), which loops max_poses times."""
    x, sk, kw = over_capacity_cases()[name]
    cfg = DecoderConfig(**kw)
    t = torch.from_numpy(x)
    ours = [o.numpy() for o in grouping.group_skeletons(
        t, sk, cfg, 17, cfg.capacity)]
    flat = [int(j) for pair in sk for j in pair]
    fake_args = (flat, 17, cfg.capacity, cfg.max_poses, cfg.settle_passes,
                 cfg.sort_dim, cfg.use_scale, cfg.dist_max, cfg.person_thre)
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = grouping._group_op(mode.from_tensor(t), *fake_args)
    assert [tuple(f.shape) for f in fake] == [o.shape for o in ours]
    jcfg = JDecoderConfig(**kw)
    xla = [np.asarray(o) for o in jgroup(jnp.asarray(x), sk, jcfg,
                                         n_keypoints=17,
                                         capacity=cfg.capacity)]
    pallas = [np.asarray(o) for o in group_skeletons_pallas(
        jnp.asarray(x), sk, jcfg, n_keypoints=17, capacity=cfg.capacity,
        interpret=True)]
    rows = min(cfg.capacity, cfg.max_poses)
    assert ours[0].shape == (len(x), cfg.max_poses, 17, 6)
    assert xla[0].shape[1] == rows and pallas[0].shape == ours[0].shape
    np.testing.assert_array_equal(ours[2], xla[2])
    np.testing.assert_array_equal(ours[2], np.full(len(x), rows))
    np.testing.assert_allclose(ours[0][:, :rows], xla[0], atol=1e-4)
    np.testing.assert_allclose(ours[1][:, :rows], xla[1], atol=1e-5)
    assert not ours[0][:, rows:].any() and not ours[1][:, rows:].any()
    np.testing.assert_array_equal(ours[2], pallas[2])
    np.testing.assert_allclose(ours[0], pallas[0], atol=1e-4)
    np.testing.assert_allclose(ours[1], pallas[1], atol=1e-5)
