"""The plain version of the port's peaks kernel equals the JAX Pallas kernel
(interpret mode, single-map and map-batched) and the XLA chain it replaces:
ys/xs exact, vals within rtol 1e-5 (the XLA chain may contract the
interpolation's multiply-adds differently)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offsetguided_tpu.ops import decoder as jdec
from offsetguided_tpu.ops.pallas.peaks_pallas import fused_peaks_topk_pallas
from offsetguided_tpu.ops.resize import upsample2d as jupsample2d
from offsetguided_tpu_torch.ops import decoder as dec
from offsetguided_tpu_torch.ops.cuda import peaks
from offsetguided_tpu_torch.ops.resize import upsample2d

RTOL, ATOL = 1e-5, 1e-6


def make_maps(kind, rng, b, h, w):
    if kind == 'pow4':
        return rng.rand(b, h, w).astype(np.float32) ** 4
    if kind == 'ties':       # coarse quantization forces equal peaks
        return (np.round(rng.rand(b, h, w) * 8) / 8).astype(np.float32)
    if kind == 'sparse':     # k above the number of positive peaks
        x = np.zeros((b, h, w), np.float32)
        x[:, h // 3, w // 4] = 0.9
        x[:, h // 2, w // 2] = 0.5
        return x
    raise ValueError(kind)


def xla_chain(x, k):
    """upsample2d + hmp_nms + topk_channel_blockreduce in JAX."""
    up = jupsample2d(jnp.asarray(x)[..., None], 4, 'bicubic')
    s, _, ys, xs = jdec.topk_channel_blockreduce(jdec.hmp_nms(up), k)
    return np.asarray(s)[:, 0], np.asarray(ys)[:, 0], np.asarray(xs)[:, 0]


def check(ours, ref):
    v, y, x = (t.numpy() for t in ours)
    np.testing.assert_array_equal(y, ref[1])
    np.testing.assert_array_equal(x, ref[2])
    np.testing.assert_allclose(v, ref[0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('kind', ['pow4', 'ties', 'sparse'])
def test_plain_matches_pallas_interpret(kind):
    rng = np.random.RandomState(3)
    b, h, k = 4, 16, 6
    x = make_maps(kind, rng, b, h, h)
    ours = peaks.peaks_topk(torch.from_numpy(x), k)
    for mb in (1, 2):
        ref = fused_peaks_topk_pallas(jnp.asarray(x), k, factor=4,
                                      method='bicubic', interpret=True,
                                      maps_per_step=mb)
        check(ours, tuple(np.asarray(r) for r in ref))


@pytest.mark.parametrize('kind,h,w,k', [
    ('pow4', 16, 16, 8), ('ties', 16, 16, 40), ('sparse', 12, 12, 10),
    ('pow4', 12, 20, 8),      # rectangular: the XLA chain only
])
def test_plain_matches_xla_chain(kind, h, w, k):
    x = make_maps(kind, np.random.RandomState(4), 3, h, w)
    check(peaks.peaks_topk(torch.from_numpy(x), k), xla_chain(x, k))


def test_upsample_bit_matches_jax():
    """Same term order as ops/resize.py: the upsampled values agree to the
    float32 rounding of each separate multiply and add."""
    x = np.random.RandomState(5).randn(2, 9, 7, 3).astype(np.float32)
    for method in ('bicubic', 'bilinear', 'nearest'):
        ours = upsample2d(torch.from_numpy(x), 4, method).numpy()
        ref = np.asarray(jupsample2d(jnp.asarray(x), 4, method))
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6,
                                   err_msg=method)


def test_upsample_matches_torch_interpolate():
    x = torch.from_numpy(
        np.random.RandomState(6).randn(1, 8, 10, 2).astype(np.float32))
    ref = torch.nn.functional.interpolate(
        x.permute(0, 3, 1, 2), scale_factor=4, mode='bicubic',
        align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(upsample2d(x, 4).numpy(), ref.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_nms_and_blockreduce_match_jax():
    x = np.random.RandomState(7).rand(2, 16, 20, 5).astype(np.float32)
    nm = dec.hmp_nms(torch.from_numpy(x))
    np.testing.assert_array_equal(nm.numpy(),
                                  np.asarray(jdec.hmp_nms(jnp.asarray(x))))
    ours = dec.topk_channel_blockreduce(nm, 6)
    ref = jdec.topk_channel_blockreduce(jnp.asarray(nm.numpy()), 6)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cpu_tensor_takes_plain_path():
    """A CPU tensor never launches the kernel."""
    before = peaks.peaks_topk.launches
    peaks.peaks_topk(torch.zeros(2, 8, 8), 4)
    assert peaks.peaks_topk.launches == before


def test_plain_matches_pallas_past_k_512():
    """k = 600 on (2, 24, 24): the JAX kernel returns a result at any k;
    positions exact, values within the file's tolerance."""
    x = make_maps('pow4', np.random.RandomState(8), 2, 24, 24)
    ours = peaks.peaks_topk(torch.from_numpy(x), 600)
    ref = fused_peaks_topk_pallas(jnp.asarray(x), 600, factor=4,
                                  method='bicubic', interpret=True)
    check(ours, tuple(np.asarray(r) for r in ref))
