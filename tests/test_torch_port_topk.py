"""The port's block top-k (`ops/cuda/topk.py`, plain version on the CPU)
equals `topk_pallas` in interpret mode and `lax.top_k`: values and indices
identical with ties, zeros past k, rectangles and -inf; and the port's
`topk_channel_blockreduce` equals the JAX one on its Pallas path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offsetguided_tpu.ops import decoder as jdec
from offsetguided_tpu.ops.pallas.topk_pallas import topk_pallas
from offsetguided_tpu_torch.ops import decoder as dec
from offsetguided_tpu_torch.ops.cuda import topk as cuda_topk


def inputs(kind, shape, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(*shape).astype(np.float32)
    if kind == 'sparse':             # NMS output: few positive cells
        x = np.where(rng.rand(*shape) < 0.05, x, 0.0).astype(np.float32)
    elif kind == 'ties':             # 1/8-quantized: long runs of equal values
        x = (np.round(x * 8) / 8).astype(np.float32)
    elif kind == 'zeros_past_k':     # fewer positive cells than k
        x = np.zeros(shape, np.float32)
        x[:, 1, 2], x[:, -1, -1] = 0.5, 0.5
    elif kind == 'neg_inf':          # masks of topk_pallas repeat an index
        x = np.where(rng.rand(*shape) < 0.9, -np.inf, x).astype(np.float32)
    return x


@pytest.mark.parametrize('kind', ['sparse', 'ties', 'zeros_past_k'])
@pytest.mark.parametrize('shape,k', [((6, 16, 24), 5), ((4, 10, 7), 12),
                                     ((3, 8, 8), 64)])
def test_plain_topk_matches_pallas_and_lax(kind, shape, k):
    x = inputs(kind, shape)
    v, i = cuda_topk.topk(torch.from_numpy(x).reshape(shape[0], -1), k)
    pv, pi = topk_pallas(jnp.asarray(x), k, interpret=True)
    lv, li = jax.lax.top_k(jnp.asarray(x).reshape(shape[0], -1), k)
    for rv, ri in ((pv, pi), (lv, li)):
        np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))


def test_plain_topk_follows_lax_on_neg_inf():
    """Past the finite values topk_pallas repeats the first masked index;
    the port returns distinct indices, as lax.top_k does."""
    x = inputs('neg_inf', (4, 6, 5), seed=3).reshape(4, -1)
    v, i = cuda_topk.topk(torch.from_numpy(x), 20)
    lv, li = jax.lax.top_k(jnp.asarray(x), 20)
    np.testing.assert_array_equal(v.numpy(), np.asarray(lv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(li))
    assert all(len(set(row)) == 20 for row in i.tolist())


def test_negative_zero_ties_with_zero():
    """-0.0 and +0.0 tie (lowest index first), as in topk_pallas's
    max/argmin rounds; lax.top_k alone orders +0.0 first."""
    x = np.zeros((2, 4, 6), np.float32)
    x[:, ::2, 1::3] = -0.0
    x[0, 2, 2], x[1, 3, 5] = 0.25, 0.75
    v, i = cuda_topk.topk(torch.from_numpy(x).reshape(2, -1), 10)
    _, pi = topk_pallas(jnp.asarray(x), 10, interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(pi))
    # values are the input's own, sign of zero included
    np.testing.assert_array_equal(
        np.signbit(v.numpy()),
        np.signbit(np.take_along_axis(x.reshape(2, -1), i.numpy(), 1)))


@pytest.mark.parametrize('shape', [(2, 16, 20, 5), (1, 12, 30, 3)])
def test_blockreduce_matches_jax_pallas_path(shape):
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    x = (np.round(x * 16) / 16).astype(np.float32)
    nmsed = jdec.hmp_nms(jnp.asarray(x))
    ref = jdec.topk_channel_blockreduce(nmsed, 6, use_pallas=True,
                                        pallas_interpret=True)
    ours = dec.topk_channel_blockreduce(dec.hmp_nms(torch.from_numpy(x)), 6)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cpu_tensor_takes_the_plain_version():
    x = torch.from_numpy(inputs('ties', (3, 9, 11)).reshape(3, -1))
    before = cuda_topk.topk.launches
    v, i = cuda_topk.topk(x, 7)
    pv, pi = cuda_topk.topk_plain(x, 7)
    assert torch.equal(v, pv) and torch.equal(i, pi)
    assert cuda_topk.topk.launches == before


def test_plain_topk_matches_pallas_past_k_512():
    """k = 600 on (2, 40, 40): the JAX kernel returns a result at any k,
    and the plain version (the kernel's reference) equals it exactly."""
    x = inputs('ties', (2, 40, 40), seed=5)
    v, i = cuda_topk.topk(torch.from_numpy(x).reshape(2, -1), 600)
    pv, pi = topk_pallas(jnp.asarray(x), 600, interpret=True)
    np.testing.assert_array_equal(v.numpy(), np.asarray(pv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(pi))
