"""The port's PoseNet with weights carried across from JAX equals the JAX
PoseNet (fp32, tiny widths), for every head and stack."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offsetguided_tpu.config.defaults import HeadsConfig as JHeadsConfig
from offsetguided_tpu.config.defaults import ModelConfig as JModelConfig
from offsetguided_tpu.models import PoseNet as JPoseNet
from offsetguided_tpu_torch.config.defaults import HeadsConfig, ModelConfig
from offsetguided_tpu_torch.models import PoseNet, state_dict_from_jax
from offsetguided_tpu_torch.models.layers import fold_batchnorm

# the tolerance of tests/test_converter_numeric.py: fp32 convolutions summed
# in another order by XLA and by PyTorch's CPU kernels
RTOL, ATOL = 2e-3, 2e-4

HEADS = {
    'default': {},
    'spread_no_bg': dict(include_spread=True, include_background=False,
                         include_jitter_offset=False),
}


def tiny(basenet='hourglass104', **heads):
    kw = dict(basenet=basenet, n_stacks=2, hg_order=2, dims=(8, 8, 12),
              modules=(1, 1, 1), cnv_dim=8, compute_dtype='float32')
    return (JModelConfig(heads=JHeadsConfig(**heads), **kw),
            ModelConfig(heads=HeadsConfig(**heads), **kw))


def random_variables(jcfg, seed=0):
    """JAX PoseNet variables with seeded, tamed random values: He-scaled
    kernels and BatchNorm variances >= 0.5, so a deep forward stays sane."""
    model = JPoseNet(jcfg)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                   train=False)
    rng = np.random.RandomState(seed)

    def draw(path, x):
        x = np.asarray(x)
        name = jax.tree_util.keystr(path)
        if x.ndim == 4:
            return (rng.randn(*x.shape) / np.sqrt(np.prod(x.shape[:3]))
                    ).astype(np.float32)
        if name.endswith("['var']"):
            return (np.abs(rng.randn(*x.shape)) + 0.5).astype(np.float32)
        return (0.5 * rng.randn(*x.shape)).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(draw, v)


def forward_both(jcfg, cfg, size, seed=1):
    jmodel, variables = random_variables(jcfg)
    net = PoseNet(cfg)
    net.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    net.eval()
    x = np.random.RandomState(seed).randn(2, size, size, 3).astype(np.float32)
    with torch.no_grad():
        ours = net(torch.from_numpy(x))
    ref = jmodel.apply(variables, jnp.asarray(x), train=False)
    return net, x, ours, ref


@pytest.mark.parametrize('size', [32, 64])
@pytest.mark.parametrize('heads', sorted(HEADS))
def test_forward_matches_jax(size, heads):
    jcfg, cfg = tiny(**HEADS[heads])
    _, _, ours, ref = forward_both(jcfg, cfg, size)
    n_checked = 0
    for key, maps in ref.items():
        for s, m in enumerate(maps):
            if m is None:
                assert ours[key][s] is None, (key, s)
                continue
            np.testing.assert_allclose(ours[key][s].numpy(), np.asarray(m),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f'{key} stack {s}')
            n_checked += 1
    assert n_checked >= 2 * 4


def test_hourglass52_matches_jax():
    jcfg, cfg = tiny(basenet='hourglass52')
    _, _, ours, ref = forward_both(jcfg, cfg, 32)
    assert len(ours['hmp']) == len(ref['hmp']) == 1
    np.testing.assert_allclose(ours['hmp'][0].numpy(),
                               np.asarray(ref['hmp'][0]), rtol=RTOL, atol=ATOL)


def test_folded_batchnorm_matches_unfolded():
    """The inference fold gives the eval-mode BatchNorm forward."""
    jcfg, cfg = tiny()
    net, x, ours, _ = forward_both(jcfg, cfg, 32)
    fold_batchnorm(net.basenet)
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in net.modules())
    with torch.no_grad():
        folded = net(torch.from_numpy(x))
    for key in ('hmp', 'omp'):
        np.testing.assert_allclose(folded[key][-1].numpy(),
                                   ours[key][-1].numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_full_width_parameter_count():
    """ModelConfig() is the full Hourglass-104 with its heads: 187.7 M."""
    with torch.device('meta'):
        net = PoseNet(ModelConfig())
    n = sum(p.numel() for p in net.parameters())
    assert n == 187_738_902
    cfg = dataclasses.replace(ModelConfig(), basenet='hourglass52')
    with torch.device('meta'):
        assert len(PoseNet(cfg).basenet.kps) == 1
