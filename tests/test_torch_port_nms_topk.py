"""The port's fused NMS + top-k (`ops/cuda/nms_topk.py`, plain version on
the CPU) equals `nms_topk_pallas` in interpret mode and the JAX
`joint_dets` chain: values and flat indices identical, adjacent equal peaks
both kept, NaN neighbours zeroing a cell."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offsetguided_tpu.ops import decoder as jdec
from offsetguided_tpu.ops.pallas.nms_topk_pallas import nms_topk_pallas
from offsetguided_tpu_torch.ops import decoder as dec
from offsetguided_tpu_torch.ops.cuda import nms_topk as cuda_nms

# the suite's worker processes share the host's cores
torch.set_num_threads(2)


def maps(kind, shape, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(*shape).astype(np.float32)
    if kind == 'pow4':
        x = x ** 4
    elif kind == 'quantized':        # plateaus: equal neighbours survive
        x = (np.round(x * 4) / 4).astype(np.float32)
    elif kind == 'adjacent_peaks':   # two equal peaks side by side
        x = 0.1 * x
        x[:, 5, 6] = x[:, 5, 7] = 0.9
        x[:, 0, 0] = x[:, 1, 0] = 0.8           # on the zero border
    elif kind == 'nan':
        x[:, 4, 4] = np.nan
    return x


@pytest.mark.parametrize('kind', ['pow4', 'quantized', 'adjacent_peaks',
                                  'nan'])
@pytest.mark.parametrize('shape,k', [((4, 24, 32), 6), ((3, 10, 17), 40)])
def test_plain_matches_pallas_and_joint_dets(kind, shape, k):
    x = maps(kind, shape)
    v, i = cuda_nms.nms_topk(torch.from_numpy(x), k)
    pv, pi = nms_topk_pallas(jnp.asarray(x), k, interpret=True)
    np.testing.assert_array_equal(v.numpy(), np.asarray(pv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(pi))
    js, ji, jy, jx = jdec.joint_dets(jnp.asarray(x.transpose(1, 2, 0)[None]),
                                     k)
    np.testing.assert_array_equal(v.numpy(), np.asarray(js)[0])
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji)[0])
    if kind == 'adjacent_peaks':
        w = shape[2]
        assert {5 * w + 6, 5 * w + 7, 0, w} <= set(i[0, :4].tolist())


@pytest.mark.parametrize('nms_kernel', [3, 5])
def test_joint_dets_matches_jax(nms_kernel):
    x = maps('quantized', (2, 14, 18, 5), seed=2)
    ref = jdec.joint_dets(jnp.asarray(x), 9, nms_kernel)
    ours = dec.joint_dets(torch.from_numpy(x), 9, nms_kernel)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cpu_tensor_takes_the_plain_version():
    x = torch.from_numpy(maps('pow4', (2, 9, 13)))
    before = cuda_nms.nms_topk.launches
    v, i = cuda_nms.nms_topk(x, 5)
    pv, pi = cuda_nms.nms_topk_plain(x, 5)
    assert torch.equal(v, pv) and torch.equal(i, pi)
    assert cuda_nms.nms_topk.launches == before


def test_plain_matches_pallas_past_k_512():
    """k = 600 on (2, 40, 40): the JAX kernel returns a result at any k,
    and the plain version (the kernel's reference) equals it exactly."""
    x = maps('pow4', (2, 40, 40), seed=5)
    v, i = cuda_nms.nms_topk(torch.from_numpy(x), 600)
    pv, pi = nms_topk_pallas(jnp.asarray(x), 600, interpret=True)
    np.testing.assert_array_equal(v.numpy(), np.asarray(pv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(pi))


def test_takes_non_contiguous_maps():
    """Non-contiguous (M, h, w) maps (a strided slice of a wider array) give
    the result of their contiguous copy."""
    out = np.random.RandomState(6).rand(10, 12, 21).astype(np.float32)
    view = torch.from_numpy(out)[:, :, 3:18]
    assert not view.is_contiguous()
    v, i = cuda_nms.nms_topk(view, 7)
    pv, pi = cuda_nms.nms_topk(view.contiguous(), 7)
    assert torch.equal(v, pv) and torch.equal(i, pi)
