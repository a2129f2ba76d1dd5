"""The port's training losses against the JAX package's: every heatmap and
offset loss variant, sqrt rescaling on and off, an all-masked batch, and
+inf / NaN sentinels in the targets. Values within rtol 1e-5 / atol 1e-6;
gradients of `total` with respect to the predictions within rtol 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offsetguided_tpu.config.defaults import LossConfig as JLossConfig
from offsetguided_tpu.ops.encoder import Targets as JTargets
from offsetguided_tpu.ops.losses import compute_losses as jcompute_losses
from offsetguided_tpu_torch.config.defaults import LossConfig
from offsetguided_tpu_torch.ops.encoder import Targets
from offsetguided_tpu_torch.ops.losses import compute_losses

# the suite's worker processes share the host's cores
torch.set_num_threads(2)

N, H, W, J, L = 2, 6, 7, 17, 19
KEYS = ('hmp', 'bg', 'jomp', 'omp', 'spread', 'scmp')


def make_case(seed, sentinels=True, spread=False):
    """Predictions (2 stacks) and targets; the offsets carry +inf and the
    scales NaN where unlabeled, as the encoder leaves them."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.rand(*s).astype(np.float32)
    tg = dict(hmp=f(N, H, W, J) ** 3, bg=f(N, H, W, 1),
              jomp=(f(N, H, W, 2) - 0.5) * 4, omp=(f(N, H, W, 2 * L) - 0.5) * 60,
              scmp=f(N, H, W, J) * 8 + 0.5, pscmp=f(N, H, W, 2 * L) * 5 + 0.5)
    if sentinels:
        tg['jomp'][rng.rand(N, H, W) < 0.4] = np.inf
        tg['omp'][rng.rand(N, H, W, 2 * L) < 0.4] = np.inf
        tg['scmp'][rng.rand(N, H, W, J) < 0.5] = np.nan
        tg['hmp'][0, 0, 0, 0] = np.nan
    preds = {k: [] for k in KEYS}
    for _ in range(2):
        preds['hmp'].append(f(N, H, W, J))
        preds['bg'].append(f(N, H, W, 1))
        preds['jomp'].append((f(N, H, W, 2) - 0.5) * 4)
        preds['omp'].append((f(N, H, W, 2 * L) - 0.5) * 60)
        preds['spread'].append((f(N, H, W, L) - 0.5) if spread else None)
        preds['scmp'].append(f(N, H, W, J) * 8)
    mask = rng.rand(N, H, W, 1) > 0.2
    return preds, tg, mask


def both(preds, tg, mask, **cfg):
    """(JAX losses and grads, port losses and grads) as numpy."""
    cfg.setdefault('stack_weights', (1.0, 2.0))
    jcfg, tcfg = JLossConfig(**cfg), LossConfig(**cfg)

    def jtotal(p):
        out = jcompute_losses(p, JTargets(**{k: jnp.asarray(v)
                                             for k, v in tg.items()}),
                              jnp.asarray(mask), jcfg)
        return out['total'], out

    jp = {k: [None if v is None else jnp.asarray(v) for v in vs]
          for k, vs in preds.items()}
    (_, jl), jg = jax.value_and_grad(jtotal, has_aux=True)(jp)
    tp = {k: [None if v is None else torch.tensor(v, requires_grad=True)
              for v in vs] for k, vs in preds.items()}
    tl = compute_losses(tp, Targets(**{k: torch.from_numpy(v)
                                       for k, v in tg.items()}),
                        torch.from_numpy(mask), tcfg)
    tl['total'].backward()
    jlosses = {k: float(v) for k, v in jl.items()}
    tlosses = {k: float(v.detach()) for k, v in tl.items()}
    grads = [(np.asarray(jg[k][s]), tp[k][s].grad.numpy())
             for k in KEYS for s in range(2) if tp[k][s] is not None
             and tp[k][s].grad is not None]
    return jlosses, tlosses, grads


def check(jl, tl, grads):
    assert set(jl) == set(tl)
    for k in jl:
        np.testing.assert_allclose(tl[k], jl[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for a, b in grads:
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b, a, rtol=1e-4,
                                   atol=1e-4 * np.abs(a).max() + 1e-12)


VARIANTS = {
    'default': {},
    'l2_no_sqrt': dict(heatmap_loss='l2', sqrt_re=False),
    'offset_l1': dict(offset_loss='offset_l1'),
    'jitter_weighted': dict(lambdas=(1.0, 1.0, 1.0, 100.0, 10.0)),
    'all_lambdas': dict(lambdas=(1.0, 0.5, 2.0, 10000.0, 10.0),
                        fgamma=1.5, ftao=0.05, offset_margin=0.01,
                        scale_margin=0.5),
}


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_losses_match_jax(variant):
    check(*both(*make_case(0), **VARIANTS[variant]))


@pytest.mark.parametrize('sqrt_re', [True, False])
def test_laplace_offset_loss_matches_jax(sqrt_re):
    preds, tg, mask = make_case(1, spread=True)
    check(*both(preds, tg, mask, offset_loss='offset_laplace',
                sqrt_re=sqrt_re,
                lambdas=(1.0, 0.0, 1.0, 100.0, 10.0)))


def test_all_masked_batch_matches_jax():
    """No labeled texel: every loss is 0 and every gradient finite (0)."""
    preds, tg, mask = make_case(2)
    jl, tl, grads = both(preds, tg, np.zeros_like(mask))
    check(jl, tl, grads)
    assert all(v == 0.0 for v in tl.values())


def test_sentinel_only_targets_match_jax():
    """Offsets all +inf and scales all NaN: only the heatmap terms count."""
    preds, tg, mask = make_case(3)
    tg['omp'][:] = np.inf
    tg['jomp'][:] = np.inf
    tg['scmp'][:] = np.nan
    jl, tl, grads = both(preds, tg, mask)
    check(jl, tl, grads)
    assert tl['omp'] == tl['scmp'] == 0.0 and tl['hmp'] > 0
