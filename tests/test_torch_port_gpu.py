"""The CUDA kernels against their plain PyTorch versions, on the card, and
each wrapper launching on its tensor's device whatever device is current.

Marked `gpu`; each test skips through the `cuda` fixture when no CUDA device
is present. Needs no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py
"""
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (adversarial_cases, crowd_limbs,  # noqa: E402
                        host_route_feed, host_route_targets_error,
                        one_step_ok, pose_sets_match, train_one_step_errors)
from offsetguided_tpu_torch.config import COCO_PERSON_SKELETON  # noqa: E402
from offsetguided_tpu_torch.config.defaults import DecoderConfig  # noqa: E402
from offsetguided_tpu_torch.ops import grouping as plain_grouping  # noqa: E402
from offsetguided_tpu_torch.ops.cuda import grouping, nms_topk, peaks, topk  # noqa: E402

pytestmark = pytest.mark.gpu
SK = tuple(COCO_PERSON_SKELETON)


def person_limbs(rng, n_img, n_persons, K=12, noise=3):
    """(N, L, K, 13) packed limbs: coherent persons plus invalid noise
    conns, off-image slots at -99999."""
    out = np.zeros((n_img, len(SK), K, 13), np.float64)
    out[..., 0:2] = out[..., 3:5] = -99999.0
    for i in range(n_img):
        joints = rng.rand(n_persons, 17, 2) * 100 + 1
        inds = np.arange(n_persons * 17).reshape(n_persons, 17) + 7
        for l, (jf, jt) in enumerate(SK):
            for p in range(n_persons):
                v1, v2 = 0.5 + 0.5 * rng.rand(2)
                a, b = joints[p, jf], joints[p, jt]
                length = max(np.linalg.norm(a - b), 0.5)
                d = rng.rand() * 2
                out[i, l, p] = [a[0], a[1], v1, b[0], b[1], v2, inds[p, jf],
                                inds[p, jt], d, length,
                                v1 * v2 * np.exp(-d / length), 6.0, 6.0]
            for q in range(n_persons, min(n_persons + noise, K)):
                a, b = rng.rand(2, 2) * 100
                out[i, l, q] = [a[0], a[1], 0.1, b[0], b[1], 0.1,
                                10000 + rng.randint(10000),
                                20000 + rng.randint(10000),
                                25 + rng.rand() * 50, 10.0, 0.01, 6.0, 6.0]
    return out


def sentinel_limbs(rng):
    x = person_limbs(rng, 2, 3)
    x[..., 6:8] += 2_500_000.0
    off = x[..., 0] < -9000.0
    for c in (0, 1, 8):
        x[..., c] = np.where(off, np.inf, x[..., c])
    x[:, ::3, -1, :] = np.nan
    x[:, 1, 0, 12] = np.nan
    return x


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.parametrize('kind', ['pow4', 'ties', 'zeros'])
@pytest.mark.parametrize('h,w,k', [(40, 40, 32), (24, 36, 48), (8, 8, 200)])
def test_peaks_kernel_matches_plain(cuda, kind, h, w, k):
    rng = np.random.RandomState(0)
    x = rng.rand(6, h, w).astype(np.float32)
    if kind == 'pow4':
        x = x ** 4
    elif kind == 'ties':
        x = (np.round(x * 8) / 8).astype(np.float32)
    else:
        x[:] = 0.0
        x[:, h // 2, w // 3] = 0.7
    maps = torch.from_numpy(x).to(cuda)
    before = peaks.peaks_topk.launches
    v, ys, xs = peaks.peaks_topk(maps, k)
    torch.cuda.synchronize()
    assert peaks.peaks_topk.launches == before + 1
    pv, pys, pxs = peaks.peaks_topk_plain(maps, k)
    assert torch.equal(ys, pys) and torch.equal(xs, pxs)
    assert torch.equal(v, pv)          # same term order: bit-equal


@pytest.mark.parametrize('inputs', ['persons', 'sentinels'])
def test_grouping_kernel_matches_plain(cuda, inputs):
    rng = np.random.RandomState(1)
    batch = (person_limbs(rng, 4, 3) if inputs == 'persons'
             else sentinel_limbs(rng)).astype(np.float32)
    cfg = DecoderConfig(person_thre=0.06, dist_max=20.0, use_scale=True,
                        max_poses=8)
    x = torch.from_numpy(batch).to(cuda)
    before = grouping.group_skeletons.launches
    p, s, c = grouping.group_skeletons(x, SK, cfg)
    torch.cuda.synchronize()
    assert grouping.group_skeletons.launches == before + 1
    rp, rs, rc = plain_grouping.group_skeletons(x, SK, cfg)
    assert torch.equal(c, rc)
    torch.testing.assert_close(s, rs, atol=1e-5, rtol=0)
    torch.testing.assert_close(p, rp, atol=1e-4, rtol=0)


# --- grouping: the JAX tests' adversarial and overflow inputs, capacity -- #

def kernel_vs_plain(x, sk, j, cfg_kw):
    """Kernel and plain grouping of one input on the card: counts equal,
    scores within 1e-5, pose sets within 1e-4 (poses whose masked-mean
    scores tie but for the order of the float sum may swap places, as in
    tests/test_grouping_adversarial.py), and on both every row past the
    kept ones exactly zero, the ranks from the capacity on included (each
    input runs at its own max_poses, above the capacity too)."""
    cfg = DecoderConfig(**cfg_kw)
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to('cuda')
    before = grouping.group_skeletons.launches
    p, s, c = grouping.group_skeletons(t, sk, cfg, n_keypoints=j,
                                       capacity=cfg.capacity)
    torch.cuda.synchronize()
    assert grouping.group_skeletons.launches == before + 1
    rp, rs, rc = plain_grouping.group_skeletons(t, sk, cfg, j, cfg.capacity)
    assert torch.equal(c, rc)
    assert p.shape == rp.shape == (len(x), cfg.max_poses, j, 6)
    torch.testing.assert_close(s, rs, atol=1e-5, rtol=0)
    assert pose_sets_match(p, rp, c, atol=1e-4)
    for poses, scores in ((p, s), (rp, rs)):
        for i, n in enumerate(c.clamp(max=cfg.max_poses).tolist()):
            assert not poses[i, n:].any() and not scores[i, n:].any()
    return c


@pytest.mark.parametrize('name', [
    'chain', 'chain_no_settle', 'equal_tie', 'extension_tie', 'fuzz',
    'crowd_40_64', 'crowd_78_64', 'crowd_78_128'])
def test_grouping_kernel_adversarial_inputs(cuda, name):
    x, sk, j, cfg = adversarial_cases()[name]
    c = kernel_vs_plain(x, sk, j, cfg)
    if name.startswith('crowd'):
        assert int(c[0]) == min(int(name.split('_')[1]), cfg['capacity'])


@pytest.mark.parametrize('capacity,k', [(128, 96), (256, 48), (200, 40),
                                        (64, 7)])
def test_grouping_kernel_large_capacity(cuda, capacity, k):
    """Crowds of colliding candidates over every limb at capacities past
    the old 64-row limit, and top-k that is no multiple of 32."""
    x = crowd_limbs(4, k, seed=capacity + k)
    c = kernel_vs_plain(x, SK, 17, dict(
        topk=k, dist_max=40.0, use_scale=False, person_thre=0.05,
        max_poses=96, capacity=capacity))
    assert int(c.min()) > 0


@pytest.mark.parametrize('capacity,max_poses', [(64, 96), (16, 40), (8, 12)])
def test_grouping_kernel_max_poses_over_capacity(cuda, capacity, max_poses):
    """max_poses above the capacity, which the kernel once refused: JAX's
    overflow input (78 skeletons) at 64 / 96, dense crowds at 16 / 40 and
    8 / 12. Every image fills its rows; the ranks from the capacity on
    are zeros on the kernel's output as on the plain one's."""
    if capacity == 64:
        x, sk, j, kw = adversarial_cases()['crowd_78_64']
    else:
        x, sk, j = crowd_limbs(4, 24, seed=capacity), SK, 17
        kw = dict(topk=24, dist_max=40.0, use_scale=False, person_thre=0.05)
    c = kernel_vs_plain(x, sk, j, dict(kw, capacity=capacity,
                                       max_poses=max_poses))
    assert c.tolist() == [capacity] * len(x)


@pytest.mark.parametrize('kind', ['persons_k40', 'all_nan', 'all_invalid'])
def test_grouping_kernel_odd_inputs(cuda, kind):
    rng = np.random.RandomState(12)
    if kind == 'persons_k40':
        x = person_limbs(rng, 3, 5, K=40, noise=6)
    else:
        x = np.full((2, len(SK), 32, 13), np.nan if kind == 'all_nan' else 0.0)
    c = kernel_vs_plain(x, SK, 17, dict(
        person_thre=0.06, dist_max=20.0, use_scale=True, max_poses=8,
        capacity=64))
    assert (int(c.min()) > 0) == (kind == 'persons_k40')


def test_grouping_kernel_refuses_too_much_shared_memory(cuda):
    """The first capacity whose state passes 227 KB raises ValueError
    without a launch; one row fewer runs."""
    M = next(m for m in range(64, 1024)
             if grouping.smem_bytes(32, 17, m, len(SK)) > grouping.MAX_SMEM)
    x = torch.from_numpy(crowd_limbs(1, 32, seed=3)).to('cuda')
    cfg = DecoderConfig(max_poses=8)
    before = grouping.group_skeletons.launches
    with pytest.raises(ValueError, match='shared memory'):
        grouping.group_skeletons(x, SK, cfg, capacity=M)
    assert grouping.group_skeletons.launches == before
    p, s, c = grouping.group_skeletons(x, SK, cfg, capacity=M - 1)
    rp, rs, rc = plain_grouping.group_skeletons(x, SK, cfg, 17, M - 1)
    torch.cuda.synchronize()
    assert torch.equal(c, rc)
    torch.testing.assert_close(p, rp, atol=1e-4, rtol=0)


def test_grouping_smem_formula_matches_the_kernel(cuda):
    from offsetguided_tpu_torch.ops.cuda import _build
    lib = _build.library('grouping')
    for K, J, M, L in ((32, 17, 64, 19), (96, 17, 128, 19), (48, 17, 256, 19),
                       (7, 5, 3, 2), (40, 7, 200, 5)):
        assert lib.og_group_smem_bytes(K, J, M, L) == grouping.smem_bytes(
            K, J, M, L)


def bits(t):
    """float32 tensor -> its int32 bit patterns (-0.0 differs from +0.0)."""
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize('kind', ['ties', 'zeros', 'neg_zero', 'neg_inf'])
@pytest.mark.parametrize('m,n,k', [(6, 5000, 32), (3, 700, 48), (2, 40, 40)])
def test_topk_kernel_matches_plain(cuda, kind, m, n, k):
    rng = np.random.RandomState(2)
    x = (np.round(rng.rand(m, n) * 8) / 8).astype(np.float32)
    if kind == 'zeros':              # most of a top-k past the last peak
        x = np.where(rng.rand(m, n) < 0.002, x, 0.0).astype(np.float32)
    elif kind == 'neg_zero':
        x = np.where(rng.rand(m, n) < 0.01, x, 0.0).astype(np.float32)
        x[:, ::3] = np.where(x[:, ::3] == 0, -0.0, x[:, ::3])
    elif kind == 'neg_inf':
        x = np.where(rng.rand(m, n) < 0.5, -np.inf, x).astype(np.float32)
    t = torch.from_numpy(x).to(cuda)
    before = topk.topk.launches
    v, i = topk.topk(t, k)
    torch.cuda.synchronize()
    assert topk.topk.launches == before + 1
    pv, pi = topk.topk_plain(t, k)
    assert torch.equal(i, pi) and torch.equal(bits(v), bits(pv))


@pytest.mark.parametrize('kind', ['pow4', 'quantized', 'nan'])
@pytest.mark.parametrize('h,w,k', [(40, 40, 32), (24, 70, 48), (5, 7, 35)])
def test_nms_topk_kernel_matches_plain(cuda, kind, h, w, k):
    rng = np.random.RandomState(3)
    x = rng.rand(5, h, w).astype(np.float32)
    if kind == 'pow4':
        x = x ** 4
    elif kind == 'quantized':
        x = (np.round(x * 4) / 4).astype(np.float32)
    else:
        x[:, h // 2, w // 2] = np.nan
    t = torch.from_numpy(x).to(cuda)
    before = nms_topk.nms_topk.launches
    v, i = nms_topk.nms_topk(t, k)
    torch.cuda.synchronize()
    assert nms_topk.nms_topk.launches == before + 1
    pv, pi = nms_topk.nms_topk_plain(t, k)
    assert torch.equal(i, pi) and torch.equal(bits(v), bits(pv))


def test_kernels_launch_on_the_tensors_device(cuda):
    """With cuda:0 current, every wrapper launches on the device of its
    tensor: cuda:0, and cuda:1 where a second card exists."""
    rng = np.random.RandomState(4)
    maps = rng.rand(4, 20, 28).astype(np.float32) ** 4
    limbs = person_limbs(rng, 2, 3).astype(np.float32)
    cfg = DecoderConfig(max_poses=8)
    for index in range(min(2, torch.cuda.device_count())):
        dev = torch.device('cuda', index)
        m, p = torch.from_numpy(maps).to(dev), torch.from_numpy(limbs).to(dev)
        with torch.cuda.device(0):
            got = [peaks.peaks_topk(m, 16), topk.topk(m.reshape(4, -1), 16),
                   nms_topk.nms_topk(m, 16),
                   grouping.group_skeletons(p, SK, cfg)[2]]
            torch.cuda.synchronize(dev)
        want = [peaks.peaks_topk_plain(m, 16),
                topk.topk_plain(m.reshape(4, -1), 16),
                nms_topk.nms_topk_plain(m, 16),
                plain_grouping.group_skeletons(p, SK, cfg)[2]]
        for g, w in zip(got, want):
            for a, b in zip(g if isinstance(g, tuple) else (g,),
                            w if isinstance(w, tuple) else (w,)):
                assert a.device == dev and torch.equal(a, b)


# --- the radix selection's edge cases (csrc/topk_select.cuh) ------------- #

def topk_case(kind, rng):
    """(x (m, n) float32 numpy, k) for one edge case of the top-k kernel,
    whose tiles hold 4,096 elements (8,192 and 16,384 are tile
    boundaries)."""
    if kind.startswith('k'):                 # k of 1, 31, 33, 512
        k = int(kind[1:])
        return (np.round(rng.rand(4, 20000) * 16) / 16).astype(np.float32), k
    if kind == 'all_zero':
        return np.zeros((3, 20000), np.float32), 33
    if kind == 'all_neg_zero':
        return np.full((3, 20000), -0.0, np.float32), 512
    if kind == 'ties_across_tiles':
        # equal values that straddle tile boundaries, under a tie of zeros
        x = np.zeros((3, 3 * 8192 + 5), np.float32)
        for i in (8190, 8191, 8192, 8193, 16383, 16384, 16385, 24580):
            x[:, i] = 0.75
        x[1, ::2] = 0.75                     # a row with thousands tied
        return x, 31
    if kind == 'padded_tile':                # a last tile of 10 elements
        x = rng.rand(3, 8192 + 10).astype(np.float32)
        x[:, :8192] = 0.0
        return x, 33
    if kind == 'nan_inf':
        x = rng.rand(5, 9000).astype(np.float32)
        x[0] = np.nan
        x[1] = -np.inf
        x[2, ::7] = np.nan
        x[3, ::3] = -np.inf
        x[3, 1::3] = np.inf
        x[4] = np.where(rng.rand(9000) < 0.5, -np.inf, np.nan)
        return x.astype(np.float32), 40
    if kind == 'unaligned_len':              # n % 4 != 0: 4-byte loads
        return (np.round(rng.rand(4, 8193) * 8) / 8).astype(np.float32), 33
    raise ValueError(kind)


@pytest.mark.parametrize('kind', [
    'k1', 'k31', 'k33', 'k512', 'all_zero', 'all_neg_zero',
    'ties_across_tiles', 'padded_tile', 'nan_inf', 'unaligned_len'])
def test_topk_kernel_selection_edges(cuda, kind):
    x, k = topk_case(kind, np.random.RandomState(5))
    t = torch.from_numpy(x).to(cuda)
    v, i = topk.topk(t, k)
    pv, pi = topk.topk_plain(t, k)
    torch.cuda.synchronize()
    assert torch.equal(i, pi) and torch.equal(bits(v), bits(pv))


def test_topk_kernel_unaligned_base(cuda):
    """A contiguous row block whose base is not 16-byte aligned takes the
    4-byte loads even though n % 4 == 0."""
    rng = np.random.RandomState(6)
    m, n = 3, 8192 + 4
    flat = torch.from_numpy(
        (np.round(rng.rand(m * n + 1) * 8) / 8).astype(np.float32)).to(cuda)
    t = flat[1:].view(m, n)
    assert t.is_contiguous() and t.data_ptr() % 16 != 0
    v, i = topk.topk(t, 33)
    pv, pi = topk.topk_plain(t, 33)
    torch.cuda.synchronize()
    assert torch.equal(i, pi) and torch.equal(bits(v), bits(pv))


@pytest.mark.parametrize('kind', ['constant', 'pow4', 'zeros'])
@pytest.mark.parametrize('h,w,k', [(17, 17, 33), (25, 39, 1), (25, 39, 31),
                                   (17, 23, 512)])
def test_peaks_kernel_selection_edges(cuda, kind, h, w, k):
    """Ragged edge tiles (a 2x2-block tile is 32 blocks a side, so the
    corner tiles of 17x17 hold 2x2 blocks, fewer than k: KEY_NONE padding);
    a constant map ties every block, across tiles; all-zero maps tie at 0."""
    rng = np.random.RandomState(7)
    x = rng.rand(5, h, w).astype(np.float32)
    if kind == 'constant':
        x[:] = 0.5
    elif kind == 'pow4':
        x = x ** 4
    else:
        x[:] = 0.0
    maps = torch.from_numpy(x).to(cuda)
    v, ys, xs = peaks.peaks_topk(maps, k)
    pv, pys, pxs = peaks.peaks_topk_plain(maps, k)
    torch.cuda.synchronize()
    assert torch.equal(ys, pys) and torch.equal(xs, pxs)
    assert torch.equal(bits(v), bits(pv))


@pytest.mark.parametrize('k', [1, 31, 33, 512])
def test_nms_topk_kernel_selection_edges(cuda, k):
    """The shared selection through nms_topk.cu: zero runs after NMS, and
    k past every tile's valid cells (a 33x40 map's edge tiles)."""
    rng = np.random.RandomState(8)
    x = (np.round(rng.rand(4, 33, 40) * 4) / 4).astype(np.float32) ** 2
    x[1] = 0.0
    t = torch.from_numpy(x).to(cuda)
    v, i = nms_topk.nms_topk(t, k)
    pv, pi = nms_topk.nms_topk_plain(t, k)
    torch.cuda.synchronize()
    assert torch.equal(i, pi) and torch.equal(bits(v), bits(pv))


# --- k past 512 in the three selection kernels, and their shared memory -- #

def assert_nms_topk_matches_plain(t, k):
    before = nms_topk.nms_topk.launches
    v, i = nms_topk.nms_topk(t, k)
    torch.cuda.synchronize()
    assert nms_topk.nms_topk.launches == before + 1
    pv, pi = nms_topk.nms_topk_plain(t, k)
    assert i.dtype == torch.int64 and v.shape == (pv.shape[0], k)
    assert torch.equal(i, pi) and torch.equal(bits(v), bits(pv))


@pytest.mark.parametrize('kernel', ['topk', 'peaks', 'nms_topk'])
@pytest.mark.parametrize('k', [513, 1024, 'all'])
def test_selection_kernels_past_k_512(cuda, kernel, k):
    """Each kernel at k = 513 and 1024, and at k = every cell (or block)
    of a small map, equals its plain version."""
    rng = np.random.RandomState(20)
    if kernel == 'topk':
        x = (np.round(rng.rand(3, 6000 if k != 'all' else 700) * 64)
             / 64).astype(np.float32)
        k = x.shape[1] if k == 'all' else k
        t = torch.from_numpy(x).to(cuda)
        v, i = topk.topk(t, k)
        pv, pi = topk.topk_plain(t, k)
        torch.cuda.synchronize()
        assert torch.equal(i, pi) and torch.equal(bits(v), bits(pv))
    elif kernel == 'peaks':
        h, w = (24, 24) if k != 'all' else (6, 5)
        k = 4 * h * w if k == 'all' else k
        maps = torch.from_numpy(rng.rand(3, h, w).astype(np.float32) ** 4)
        v, ys, xs = peaks.peaks_topk(maps.to(cuda), k)
        pv, pys, pxs = peaks.peaks_topk_plain(maps.to(cuda), k)
        torch.cuda.synchronize()
        assert torch.equal(ys, pys) and torch.equal(xs, pxs)
        assert torch.equal(bits(v), bits(pv))
    else:
        h, w = (40, 40) if k != 'all' else (5, 7)
        k = h * w if k == 'all' else k
        x = (np.round(rng.rand(3, h, w) * 4) / 4).astype(np.float32)
        assert_nms_topk_matches_plain(torch.from_numpy(x).to(cuda), k)


@pytest.mark.parametrize('kernel', ['topk', 'peaks', 'nms_topk'])
def test_selection_kernels_past_65535_maps(cuda, kernel):
    """65,543 small maps, past the 65,535 blocks of one grid y or z, in one
    call: each kernel equals its plain version on every map, the last
    chunk's included."""
    rng = np.random.RandomState(21)
    m = 65535 + 8
    x = torch.from_numpy((np.round(rng.rand(m, 4, 4) * 16) / 16)
                         .astype(np.float32)).to(cuda)
    if kernel == 'topk':
        before = topk.topk.launches
        v, i = topk.topk(x.reshape(m, 16), 5)
        pv, pi = topk.topk_plain(x.reshape(m, 16), 5)
        torch.cuda.synchronize()
        assert topk.topk.launches == before + 1
        assert torch.equal(i, pi) and torch.equal(bits(v), bits(pv))
    elif kernel == 'peaks':
        v, ys, xs = peaks.peaks_topk(x, 8)
        pv, pys, pxs = peaks.peaks_topk_plain(x, 8)
        torch.cuda.synchronize()
        assert torch.equal(ys, pys) and torch.equal(xs, pxs)
        assert torch.equal(bits(v), bits(pv))
    else:
        assert_nms_topk_matches_plain(x, 5)


def test_selection_smem_formulas_match_the_kernels(cuda):
    """Each wrapper's shared-memory formula equals what its C code counts
    from the kernels' own static sizes."""
    from offsetguided_tpu_torch.ops.cuda import _build
    for k in (1, 32, 33, 64, 512, 513, 1024, 3000, 5000):
        assert _build.library('topk').og_topk_smem_bytes(k) == \
            topk.smem_bytes(k)
        assert _build.library('peaks').og_peaks_smem_bytes(k) == \
            peaks.smem_bytes(k)
        for h, w in ((160, 160), (160, 256), (5, 7), (300, 700), (1, 1)):
            assert _build.library('nms_topk').og_nms_topk_smem_bytes(
                h, w, k) == nms_topk.smem_bytes(h, w, k)


@pytest.mark.parametrize('kernel', ['topk', 'peaks', 'nms_topk'])
def test_selection_kernels_refuse_past_227kb(cuda, kernel):
    """The first k whose shared memory passes 227 KB raises ValueError
    without a launch; one less runs and equals the plain version."""
    rng = np.random.RandomState(21)
    if kernel == 'topk':
        fn, plain, bytes_at = topk.topk, topk.topk_plain, topk.smem_bytes
        x = rng.rand(2, 20000)
    elif kernel == 'peaks':
        fn, plain, bytes_at = (peaks.peaks_topk, peaks.peaks_topk_plain,
                               peaks.smem_bytes)
        x = rng.rand(2, 64, 64)
    else:
        fn, plain = nms_topk.nms_topk, nms_topk.nms_topk_plain
        x = rng.rand(2, 64, 64)
        bytes_at = lambda k: nms_topk.smem_bytes(64, 64, k)  # noqa: E731
    t = torch.from_numpy(x.astype(np.float32)).to(cuda)
    k = next(k for k in range(1, 1 << 16) if bytes_at(k) > 232448)
    before = fn.launches
    with pytest.raises(ValueError, match='shared memory'):
        fn(t, k)
    assert fn.launches == before
    got, want = fn(t, k - 1), plain(t, k - 1)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# --- the one-launch NMS + top-k on the inputs its design must not miss --- #

def nms_case(kind, rng):
    """(maps float32 numpy, k) for one input of the band design: value
    classes, band boundaries, tiles and the slow exact path."""
    if kind == 'few_positive':       # zero fill starts in a later band
        x = np.zeros((3, 64, 64), np.float32)
        x[:, 2, 5], x[:, 3, 40], x[1, 50, 7] = 0.5, 0.25, 0.75
        return x, 40
    if kind == 'all_zero':
        return np.zeros((3, 40, 40), np.float32), 100
    if kind == 'all_negative':       # non-survivors are 0; few negatives
        return -rng.rand(3, 40, 40).astype(np.float32) - 0.1, 600
    if kind == 'constant_negative':  # interior cells all survive at -1
        x = np.full((2, 40, 40), -1.0, np.float32)
        x[1, 10:20, 10:20] = -0.5
        return x, 1000
    if kind == 'neg_zero':           # -0.0 cells, some surviving as -0.0
        x = np.where(rng.rand(3, 48, 48) < 0.02, rng.rand(3, 48, 48),
                     -0.0).astype(np.float32)
        x[:, 20:30, 20:30] = np.where(rng.rand(10, 10) < 0.5, -0.0, -0.25)
        return x, 200
    if kind == 'inf_nan':
        x = rng.rand(3, 40, 40).astype(np.float32)
        x[0, 5, 5], x[0, 30, 30] = np.inf, -np.inf
        x[1, ::7, ::5] = np.nan
        x[2] = -np.inf
        x[2, 10, 10] = np.nan
        return x, 64
    if kind == 'ragged_bands':       # h not a multiple of the 8 bands
        return rng.rand(3, 37, 41).astype(np.float32) ** 4, 50
    if kind == 'tiled_bands':        # row tiles, list cut back
        return rng.rand(2, 300, 600).astype(np.float32) ** 4, 300
    if kind == 'wide':               # column tiles too
        return rng.rand(2, 20, 2100).astype(np.float32) ** 4, 100
    if kind == 'wide_sparse':        # zero fill across column tiles
        x = np.zeros((2, 16, 2100), np.float32)
        x[:, 1, 2090], x[:, 9, 3] = 0.5, 0.25
        return x, 64
    if kind == 'tall_sparse':        # bands past the zero mask's cells
        x = np.zeros((2, 600, 200), np.float32)
        x[:, 100, 100], x[:, 599, 0] = 0.5, 0.25
        return x, 300
    if kind == 'plateaus':           # every cell of a band survives
        return (np.round(rng.rand(3, 64, 300) * 2) / 2).astype(np.float32), 700
    if kind == 'lowres_fixed_height':
        return rng.rand(136, 160, 256).astype(np.float32) ** 4, 32
    raise ValueError(kind)


@pytest.mark.parametrize('kind', [
    'few_positive', 'all_zero', 'all_negative', 'constant_negative',
    'neg_zero', 'inf_nan', 'ragged_bands', 'tiled_bands', 'wide',
    'wide_sparse', 'tall_sparse', 'plateaus', 'lowres_fixed_height'])
@pytest.mark.parametrize('path', ['k_to_32', 'k_over_32'])
def test_nms_topk_kernel_value_classes(cuda, kind, path):
    """Each input at a k of the warp-sorted lists (k <= 32) and of the
    radix-selected ones (k > 32)."""
    x, k = nms_case(kind, np.random.RandomState(22))
    k = min(k, 20) if path == 'k_to_32' else max(k, 33)
    assert_nms_topk_matches_plain(torch.from_numpy(x).to(cuda), k)


@pytest.mark.parametrize('h', [1, 2, 3, 4, 5])
def test_nms_topk_kernel_tiny_maps(cuda, h):
    """Maps of 1x1 to 5x7, at k = 1 and k = every cell: bands with no rows
    give no keys."""
    rng = np.random.RandomState(23 + h)
    for w in range(1, 8):
        x = (np.round(rng.rand(4, h, w) * 3) / 3 - 0.3).astype(np.float32)
        for k in sorted({1, h * w}):
            assert_nms_topk_matches_plain(torch.from_numpy(x).to(cuda), k)


def test_nms_topk_kernel_takes_non_contiguous_maps(cuda):
    """Non-contiguous (M, h, w) maps (a strided slice of a wider array): the
    wrapper launches on a contiguous copy."""
    rng = np.random.RandomState(24)
    out = torch.from_numpy(rng.rand(14, 30, 51).astype(np.float32) ** 4)
    view = out.to(cuda)[:, :, 5:45]
    assert not view.is_contiguous()
    assert_nms_topk_matches_plain(view, 24)
    v, i = nms_topk.nms_topk(view, 24)
    pv, pi = nms_topk.nms_topk(view.contiguous(), 24)
    assert torch.equal(i, pi) and torch.equal(bits(v), bits(pv))


def test_host_route_train_step_matches_cpu(cuda, tmp_path):
    """A host-route batch (warped, grayed and tinted on the host; encoded
    on each device): targets card vs CPU within 1e-6, and one SGD step of
    the tiny model within the one-step tolerances (losses 1e-4 relative,
    gradients 1e-3 relative + 1e-4 of the largest, BatchNorm statistics
    1e-5), in fp64: in fp32 this batch meets a near-tie of rounding on the
    card (ROADMAP Queue 3)."""
    feed = host_route_feed(str(tmp_path))
    assert host_route_targets_error(cuda, feed) <= 1e-6
    e = train_one_step_errors(cuda, feed, 'float64')
    assert one_step_ok(e), e


# --- the CrowdPose skeleton: J = 14, L = 17, the kernel's general build -- #

def crowdpose_limbs(kind):
    """Packed (N, 17, K, 13) limbs on the CrowdPose skeleton and their
    decoder config: 'oracle' the GT oracle's limbs of the six scenes of
    tests/test_crowdpose_e2e.py (encoded and decoded on the card), 'model'
    a narrow random CrowdPose model's on noise at 256^2, 'crowd_128' a
    dense crowd at capacity 128, top-k 96."""
    from chip_smoke import (CROWDPOSE_DECODE, CROWDPOSE_SCENES, J14,
                            crowdpose_persons)
    from offsetguided_tpu_torch.config.defaults import (
        EncoderConfig, HeadsConfig, ModelConfig, SkeletonConfig)
    from offsetguided_tpu_torch.decoder import PostProcessor
    from offsetguided_tpu_torch.models import random_posenet
    from offsetguided_tpu_torch.ops.encoder import encode_targets
    from offsetguided_tpu_torch.ops.image import normalize_images
    sk = SkeletonConfig.crowdpose()
    if kind == 'crowd_128':
        return (torch.from_numpy(crowd_limbs(4, 96, seed=14, L=17,
                                             skeleton=sk.skeleton)).cuda(),
                DecoderConfig(topk=96, dist_max=40.0, use_scale=False,
                              person_thre=0.05, max_poses=96, capacity=128))
    if kind == 'oracle':
        anns = np.zeros((len(CROWDPOSE_SCENES), 8, J14, 4), np.float32)
        for i, (_, placements) in enumerate(CROWDPOSE_SCENES):
            anns[i, :len(placements), :, :3] = crowdpose_persons(
                [(x / 2, y / 2, b / 2) for x, y, b in placements], seed=i)
            anns[i, :len(placements), :, 3] = 3.0
        t = encode_targets(torch.from_numpy(anns).cuda(), sk.sigmas,
                           sk.skeleton, 40, 40, EncoderConfig(max_persons=8))
        cfg = DecoderConfig(**CROWDPOSE_DECODE)
        preds = {'hmp': [t.hmp], 'jomp': [t.jomp], 'omp': [t.omp],
                 'scmp': [None]}
    else:
        cfg = DecoderConfig(topk=32, thre_hmp=0.04, dist_max=40.0)
        model = random_posenet(ModelConfig(
            n_stacks=1, hg_order=2, dims=(8, 8, 12), modules=(1, 1, 1),
            cnv_dim=8, compute_dtype='float32',
            heads=HeadsConfig(n_keypoints=14, n_limbs=17)), 0, 'cuda',
            calib_size=256).prepare_inference()
        x = torch.from_numpy(np.random.RandomState(3).randint(
            0, 256, (4, 256, 256, 3), dtype=np.uint8)).cuda()
        with torch.inference_mode():
            preds = model(normalize_images(x))
    packed = PostProcessor(skeleton=sk, cfg=cfg).decode_packed_limbs(preds)
    return packed.contiguous(), cfg


@pytest.mark.parametrize('kind', ['oracle', 'model', 'crowd_128'])
def test_grouping_kernel_crowdpose(cuda, kind):
    """The general build (`group_kernel<0>`) at J = 14, L = 17 against the
    plain grouping: the oracle's and a model's limbs, and a crowd at
    capacity 128."""
    from offsetguided_tpu_torch.config.defaults import SkeletonConfig
    x, cfg = crowdpose_limbs(kind)
    assert x.shape[1] == 17
    c = kernel_vs_plain(x.cpu().numpy(), SkeletonConfig.crowdpose().skeleton,
                        14, dataclasses.asdict(cfg))
    assert int(c.sum()) > 0


@pytest.mark.parametrize('kernel', ['peaks', 'nms_topk', 'topk'])
def test_selection_kernels_at_crowdpose_maps(cuda, kernel):
    """The three selection kernels on M = 8 * 14 maps, the CrowdPose
    batch's: (112, 160, 160) square maps for peaks and NMS + top-k, the
    fixed-height block maxima (112, 80 * 128) for block top-k."""
    rng = np.random.RandomState(14)
    if kernel == 'topk':
        x = torch.from_numpy((np.round(rng.rand(112, 80 * 128) * 64) / 64)
                             .astype(np.float32)).to(cuda)
        v, i = topk.topk(x, 32)
        pv, pi = topk.topk_plain(x, 32)
        assert torch.equal(i, pi) and torch.equal(bits(v), bits(pv))
        return
    x = torch.from_numpy(rng.rand(112, 160, 160).astype(np.float32) ** 4
                         ).to(cuda)
    if kernel == 'peaks':
        v, ys, xs = peaks.peaks_topk(x, 32)
        pv, pys, pxs = peaks.peaks_topk_plain(x, 32)
        assert torch.equal(ys, pys) and torch.equal(xs, pxs)
        assert torch.equal(bits(v), bits(pv))
    else:
        assert_nms_topk_matches_plain(x, 32)


@pytest.mark.parametrize('shape', ['small', 'bench'])
def test_tiled_warp_matches_patch_on_the_card(cuda, shape):
    """`affine_sample_tiled` against `affine_sample` on the card, with the
    caller's float32 matmul precision at 'high' (TF32 allowed): within the
    JAX package's tolerance (rtol 1e-3, atol 0.05), and the tiled warp on
    the card within 1e-3 of the tiled warp on the CPU (small shape). The
    caller's precision comes back after."""
    from offsetguided_tpu_torch.ops import augment
    rng = np.random.RandomState(5)
    n, h, w, out = (2, 45, 57, (31, 50)) if shape == 'small' else \
        (4, 640, 640, (512, 512))
    images = rng.randint(0, 256, (n, h, w, 4), dtype=np.uint8)
    mats = []
    for _ in range(n):
        th, sc = rng.uniform(-np.pi / 4, np.pi / 4), rng.uniform(0.5, 2.0)
        fwd = np.array([[np.cos(th) * sc, -np.sin(th) * sc],
                        [np.sin(th) * sc, np.cos(th) * sc]])
        mats.append(np.hstack([np.linalg.inv(fwd),
                               rng.uniform(-40, 40, (2, 1))]))
    mats = np.stack(mats).astype(np.float32)
    valid = np.stack([[h, w], [h - 7, w - 11]] * (n // 2)).astype(np.int32)
    border = torch.tensor([124.0, 116.0, 104.0, 255.0])
    args = [torch.from_numpy(a) for a in (images, mats)]
    dev_args = [a.to(cuda) for a in args]
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision('high')
    try:
        t = augment.affine_sample_tiled(*dev_args, out, border.to(cuda),
                                        torch.from_numpy(valid).to(cuda),
                                        slope_bound=3.0)
        assert torch.get_float32_matmul_precision() == 'high'
    finally:
        torch.set_float32_matmul_precision(saved)
    p = augment.affine_sample(*dev_args, out, border.to(cuda),
                              torch.from_numpy(valid).to(cuda))
    torch.testing.assert_close(t, p, rtol=1e-3, atol=0.05)
    if shape == 'small':
        c = augment.affine_sample_tiled(*args, out, border,
                                        torch.from_numpy(valid),
                                        slope_bound=3.0)
        torch.testing.assert_close(t.cpu(), c, rtol=0, atol=1e-3)


def custom_op_cases(cuda):
    """(op, wrapper, plain, args) for each kernel's custom op on CUDA
    tensors of its path's kind."""
    rng = np.random.RandomState(8)
    maps = torch.from_numpy(rng.rand(34, 40, 40).astype(np.float32) ** 4
                            ).to(cuda)
    flat = torch.from_numpy(rng.rand(34, 1600).astype(np.float32)).to(cuda)
    limbs = torch.from_numpy(person_limbs(rng, 2, 3).astype(np.float32)
                             ).to(cuda)
    cfg = DecoderConfig()
    skel = [j for pair in SK for j in pair]
    ops = torch.ops.offsetguided
    return {
        'peaks_topk': (ops.peaks_topk.default, peaks.peaks_topk,
                       lambda: peaks.peaks_topk_plain(maps, 32),
                       (maps, 32, 'bicubic')),
        'topk': (ops.topk.default, topk.topk,
                 lambda: topk.topk_plain(flat, 32), (flat, 32)),
        'nms_topk': (ops.nms_topk.default, nms_topk.nms_topk,
                     lambda: nms_topk.nms_topk_plain(maps, 32), (maps, 32)),
        'group_skeletons': (
            ops.group_skeletons.default, grouping.group_skeletons,
            lambda: plain_grouping.group_skeletons(limbs, SK, cfg),
            (limbs, skel, 17, cfg.capacity, cfg.max_poses,
             cfg.settle_passes, cfg.sort_dim, cfg.use_scale, cfg.dist_max,
             cfg.person_thre)),
    }


@pytest.mark.parametrize('name', ['peaks_topk', 'topk', 'nms_topk',
                                  'group_skeletons'])
def test_custom_op_launches_the_kernel(cuda, name):
    """`torch.ops.offsetguided.<name>` on CUDA tensors launches the kernel
    (its wrapper's count goes up by one), passes `torch.library.opcheck`
    (the fake implementation's shapes, dtypes and strides, no aliasing)
    and equals the plain version."""
    op, wrapper, plain, args = custom_op_cases(cuda)[name]
    before = wrapper.launches
    out = op(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    torch.library.opcheck(op, args)
    want = plain()
    if name == 'group_skeletons':
        assert torch.equal(out[2], want[2])
        torch.testing.assert_close(out[1], want[1], atol=1e-5, rtol=0)
        assert pose_sets_match(out[0], want[0], out[2], 1e-4)
        return
    for a, b in zip(out, want):
        assert torch.equal(a, b)


def test_export_with_decode_on_the_card(cuda, tmp_path):
    """A tiny fp32 model's forward + decode exported on the card, saved and
    loaded: bit-equal to the eager run, the peaks and grouping kernels
    launched by the loaded program."""
    from offsetguided_tpu_torch.cli import export
    from offsetguided_tpu_torch.decoder import PostProcessor
    from offsetguided_tpu_torch.ops.image import normalize_images
    args = export.cli(['--debug-tiny-model', '--input-size', '128'])
    model = export.build_model(args, cuda).prepare_inference()
    pp = PostProcessor(cfg=DecoderConfig())
    x = normalize_images(torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (2, 128, 128, 3), dtype=np.uint8)).to(cuda))
    path = str(tmp_path / 'tiny.pt2')
    torch.export.save(export.export_program(model, x, pp), path)
    with torch.inference_mode():
        eager = export.Forward(model, pp)(x)
    program = torch.export.load(path).module()
    before = (peaks.peaks_topk.launches, grouping.group_skeletons.launches)
    got = program(x)
    torch.cuda.synchronize()
    assert (peaks.peaks_topk.launches, grouping.group_skeletons.launches) == \
        (before[0] + 1, before[1] + 1)
    for a, b in zip(got, eager):
        assert torch.equal(a, b)


# --- the eval loop on the card: sync-free issue, overlapped fetch -------- #

# route -> (dataset, flip test, input (h, w), decoder settings): the square
# peaks route, fixed height's non-square route with flip (upsample +
# block top-k), the stride-resolution route (NMS + top-k)
INFER_ROUTES = {
    'square': ('coco', False, (64, 64), {}),
    'fh_flip': ('crowdpose', True, (64, 128), {}),
    'lowres': ('coco', False, (64, 64), dict(upsampled_decode=False)),
}
ROUTE_KERNEL = {'square': peaks.peaks_topk, 'fh_flip': topk.topk,
                'lowres': nms_topk.nms_topk}


def tiny_eval_model(device, dataset, flip, **decoder):
    """A tiny fp32 PoseNet of the dataset's heads on `device` and its infer
    function; zero thresholds, so random weights still give poses."""
    from offsetguided_tpu_torch.config.defaults import (HeadsConfig,
                                                        ModelConfig,
                                                        SkeletonConfig)
    from offsetguided_tpu_torch.decoder import PostProcessor
    from offsetguided_tpu_torch.eval.harness import make_infer_fn
    from offsetguided_tpu_torch.models import PoseNet
    sk = SkeletonConfig.for_dataset(dataset)
    cfg = ModelConfig(n_stacks=1, hg_order=2, dims=(8, 8, 12),
                      modules=(1, 1, 1), cnv_dim=8, compute_dtype='float32',
                      heads=HeadsConfig(n_keypoints=sk.n_keypoints,
                                        n_limbs=sk.n_limbs))
    torch.manual_seed(0)
    model = PoseNet(cfg).eval().to(device).prepare_inference()
    pp = PostProcessor(skeleton=sk, cfg=DecoderConfig(
        topk=8, thre_hmp=0.0, dist_max=40.0, person_thre=0.0, **decoder))
    return model, pp, sk, make_infer_fn(model, pp, flip)


@pytest.mark.parametrize('route', sorted(INFER_ROUTES))
def test_warm_infer_issues_without_a_sync(cuda, route):
    """After one warm call, the infer function (normalization, forward,
    flip merge, decode and the route's kernels) makes no synchronizing
    call: `set_sync_debug_mode('error')` raises on one. Twice, each equal
    to the warm call bit for bit, the route's kernel launched each time."""
    dataset, flip, (h, w), kw = INFER_ROUTES[route]
    _, _, _, infer = tiny_eval_model(cuda, dataset, flip, **kw)
    x = torch.from_numpy(np.random.RandomState(5).randint(
        0, 256, (2, h, w, 3), dtype=np.uint8)).to(cuda)
    warm = infer(x)
    torch.cuda.synchronize()
    kernel = ROUTE_KERNEL[route]
    before = kernel.launches
    outs = []
    torch.cuda.set_sync_debug_mode('error')
    try:
        for _ in range(2):
            outs.append(infer(x))
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert int(warm[2].sum()) > 0
    for out in outs:
        for a, b in zip(out, warm):
            assert torch.equal(a, b)


def test_run_images_equals_batch_by_batch_fetches(cuda, tmp_path):
    """`run_images` on the card (pinned copies, batch N+1 issued before N
    is fetched) gives the records the loop makes when it fetches each
    batch with `.cpu()` before issuing the next: fixed height, flip, three
    padded widths, a partial batch at each shape change."""
    import json

    from offsetguided_tpu_torch.config.defaults import EvalConfig
    from offsetguided_tpu_torch.data import transforms as T
    from offsetguided_tpu_torch.data.coco import CocoJson
    from offsetguided_tpu_torch.eval import harness
    from offsetguided_tpu_torch.utils.profiling import RECORDER
    rng = np.random.RandomState(6)
    # height 64; widths padded to 64, 128 and 192
    widths = [40, 60, 60, 100, 110, 120, 120, 120, 150, 170, 180]
    images = []
    (tmp_path / 'images').mkdir()
    for i, w in enumerate(widths, start=1):
        np.save(tmp_path / 'images' / f'{i}.npy',
                rng.randint(0, 256, (64, w, 3), dtype=np.uint8))
        images.append({'id': i, 'file_name': f'{i}.npy', 'height': 64,
                       'width': w})
    ann = tmp_path / 'annotations.json'
    ann.write_text(json.dumps({'images': images, 'annotations': [],
                               'categories': [{'id': 1, 'name': 'person'}]}))
    model, pp, sk, infer = tiny_eval_model(cuda, 'crowdpose', True)
    cfg = EvalConfig(long_edge=64, fixed_height=True, max_stride=32,
                     width_bucket=64, flip_test=True, batch_size=4,
                     io_workers=2)
    coco = CocoJson(str(ann))
    t_begin = time.perf_counter()
    got = harness.run_images(model, pp, coco, str(tmp_path / 'images'), cfg,
                             skeleton=sk, all_images=True)
    t_end = time.perf_counter()

    ids = sorted(harness.eval_image_ids(coco, all_images=True),
                 key=lambda i: coco.image_info(i)['width']
                 / coco.image_info(i)['height'])
    loaded = [harness._load_eval_image(coco, str(tmp_path / 'images'), i,
                                       cfg, sk.n_keypoints) for i in ids]
    batches, cur = [], []
    for item in loaded:
        if cur and item[1].shape != cur[0][1].shape:
            batches.append(cur)
            cur = []
        cur.append(item)
        if len(cur) == cfg.batch_size:
            batches.append(cur)
            cur = []
    batches.append(cur)
    assert len({b[0][1].shape for b in batches}) == 3
    assert sum(len(b) < cfg.batch_size for b in batches) >= 2
    want = []
    for batch in batches:
        imgs = [img for _, img, _ in batch]
        imgs += [np.zeros_like(imgs[0])] * (cfg.batch_size - len(imgs))
        poses, _, counts = infer(torch.from_numpy(np.stack(imgs)).to(cuda))
        poses, counts = poses.cpu().numpy(), counts.cpu().numpy()
        for i, (img_id, _, meta) in enumerate(batch):
            inv = T.annotations_inverse(poses[i][:int(counts[i])], meta)
            want.extend(harness.poses_to_coco_results(inv, img_id))
    assert got == want
    assert any(r['score'] != 0.01 for r in got)
    w = RECORDER.window(t_begin, t_end)
    assert len(w.overlaps) == len(batches)


# --- data parallel on the card, and the progressive JPEG bodies ---------- #

def tiny_step_kw():
    """The one-step check's tiny model, weights and batch
    (`chip_smoke.tiny_train_batch`, two images)."""
    from chip_smoke import TINY_TRAIN, tiny_train_batch
    from offsetguided_tpu_torch.config.defaults import ModelConfig
    from offsetguided_tpu_torch.models import PoseNet
    from offsetguided_tpu_torch.models.network import init_reference_
    images, anns, mask = tiny_train_batch()
    init = init_reference_(PoseNet(ModelConfig(**TINY_TRAIN)),
                           torch.Generator().manual_seed(0))
    return dict(model_kw=TINY_TRAIN, images=images, anns=anns, mask=mask,
                state={k: v.numpy() for k, v in init.state_dict().items()})


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_two_gloo_ranks_on_one_card_match_one_process(cuda, dtype):
    """One SGD step (TF32 off) of the tiny model: two gloo ranks sharing
    the card, one image each, against this process on the whole batch;
    the ranks bit-equal, and within the one-step tolerances of the one
    process."""
    from offsetguided_tpu_torch.parallel import distributed, parity
    kw = tiny_step_kw()
    ranks = distributed.spawn(parity.run_cases, 2, [
        ('step', 'train_step', dict(kw, dtype=dtype))], 'cuda', True, 2)
    assert ranks[0]['step']['digest'] == ranks[1]['step']['digest']
    e = parity.step_errors(kw['state'], parity.train_step(cuda, **kw,
                                                          dtype=dtype),
                           ranks[0]['step'])
    assert one_step_ok(e), e


def test_frozen_train_step_matches_cpu(cuda):
    """One SGD step of the tiny model with `--freeze Hourglass104_0
    --max-grad-norm 1e-3` (TF32 off) on the card against the CPU: within
    the one-step tolerances, the frozen weights bit-equal to their start
    on the card."""
    from offsetguided_tpu_torch.parallel import parity
    kw = dict(tiny_step_kw(), freeze='Hourglass104_0', max_grad_norm=1e-3)
    got = parity.train_step(cuda, **kw)
    e = parity.step_errors(kw['state'], parity.train_step('cpu', **kw), got)
    assert one_step_ok(e), e
    frozen = [k for k in kw['state'] if k.startswith('basenet.')
              and k.endswith(('weight', 'bias'))]
    assert frozen
    for k in frozen:
        np.testing.assert_array_equal(got['state'][k], kw['state'][k])


def test_one_nccl_rank_matches_one_process(cuda):
    """World size 1 over NCCL (DDP, the synchronized BatchNorm and the
    global normalizers with one rank) against the one-process step, fp32,
    TF32 off: within the one-step tolerances."""
    from offsetguided_tpu_torch.parallel import distributed, parity
    kw = tiny_step_kw()
    ranks = distributed.spawn(parity.run_cases, 1, [
        ('step', 'train_step', kw)], 'cuda', False, 2)
    e = parity.step_errors(kw['state'], parity.train_step(cuda, **kw),
                           ranks[0]['step'])
    assert one_step_ok(e), e


def test_progressive_bodies_decode_to_the_pinned_digests(cuda):
    """The committed progressive JPEG bodies decode on the card's host to
    the pixels cv2.imdecode gave on the CPU (`PROGRESSIVE_DIGESTS`)."""
    from chip_smoke import PROGRESSIVE_DIGESTS, codec_digests, progressive_cases
    from offsetguided_tpu_torch.data import codec
    for name, body in progressive_cases():
        assert codec_digests(body, codec.decode(body)) == \
            PROGRESSIVE_DIGESTS[name][1:], name
