"""Data-parallel training (`parallel/distributed.py`, the synchronized
`BatchNorm2d`, `compute_losses`' global normalizers, `TrainStep` under
DDP) at two gloo ranks on the CPU, against the same code on the whole
batch in one process and against the JAX package's `jit_train_step` on a
`make_mesh(2, 1)` mesh: one spawn of two ranks runs every case
(`parallel/parity.py`), and the JAX step compiles once."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offsetguided_tpu.config.defaults import LossConfig as JLossConfig
from offsetguided_tpu.config.defaults import TrainConfig as JTrainConfig
from offsetguided_tpu.models import PoseNet as JPoseNet
from offsetguided_tpu.parallel import (batch_sharding, create_train_state,
                                       jit_train_step, make_mesh, replicated)
from offsetguided_tpu.parallel import make_optimizer as jmake_optimizer
from offsetguided_tpu_torch.config.coco import (COCO_PERSON_SIGMAS,
                                                COCO_PERSON_SKELETON)
from offsetguided_tpu_torch.config.defaults import (EncoderConfig,
                                                    LossConfig)
from offsetguided_tpu_torch.models import checkpoint as ckpt
from offsetguided_tpu_torch.models.layers import BatchNorm2d
from offsetguided_tpu_torch.ops.encoder import Targets, encode_targets
from offsetguided_tpu_torch.ops.losses import compute_losses
from offsetguided_tpu_torch.parallel import distributed, parity
from test_torch_port_train import (configs, flat, init_variables, port_step,
                                   synth_batch, targets_both)

# the suite's worker processes share the host's cores
torch.set_num_threads(2)

WORLD = 2
# `--freeze` of the backbone with a clip that binds (on the trainable
# gradients' norm)
FREEZE = dict(freeze='Hourglass104_0', max_grad_norm=1e-3)
TINY1 = dict(n_stacks=1, hg_order=2, dims=(16, 16, 24), modules=(1, 1, 1),
             cnv_dim=16, compute_dtype='float32')


def bn_inputs(dtype, seed):
    """(4, 6, 5, 7) activations with per-channel offsets, the layer's
    parameters, running statistics and an upstream gradient."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(4, 6, 5, 7) * 2.0 + rng.randn(1, 6, 1, 1) * 3.0)
    return dict(x=x.astype(dtype), weight=rng.rand(6).astype(dtype) + 0.5,
                bias=rng.randn(6).astype(dtype),
                dy=rng.randn(4, 6, 5, 7).astype(dtype),
                running_mean=rng.randn(6).astype(dtype),
                running_var=rng.rand(6).astype(dtype) + 0.5)


def loss_inputs():
    """Predictions and targets of a 4-image batch whose two halves hold
    different numbers of labeled elements: images 0 and 1 (rank 0) hold
    three persons each, images 2 and 3 (rank 1) one with half its
    keypoints, and image 2 a masked band."""
    rng = np.random.RandomState(3)
    anns = np.zeros((4, 3, 17, 4), np.float32)
    anns[..., :2] = rng.rand(4, 3, 17, 2) * 64
    anns[..., 3] = 4.0 + rng.rand(4, 3, 17)
    anns[:2, :, :, 2] = 2.0
    anns[2:, 0, ::2, 2] = 2.0
    t = encode_targets(anns, COCO_PERSON_SIGMAS, COCO_PERSON_SKELETON, 16,
                       16, EncoderConfig(max_persons=3))
    targets = {k: v.numpy() for k, v in t._asdict().items()}
    mask = np.ones((4, 16, 16, 1), bool)
    mask[2, 4:9] = False

    def like(key, scale, shift=0.0):
        return [(rng.randn(*targets[key].shape) * scale + shift)
                .astype(np.float32)]

    preds = dict(hmp=[rng.rand(*targets['hmp'].shape).astype(np.float32)],
                 bg=[rng.rand(*targets['bg'].shape).astype(np.float32)],
                 jomp=like('jomp', 2.0), omp=like('omp', 4.0),
                 spread=[None], scmp=like('scmp', 1.0, 3.0))
    return preds, targets, mask


def step_inputs():
    """The one-step test's batch, weights and tiny one-stack model
    (`test_torch_port_train.test_one_train_step_matches_jax`): image 0's
    masked band gives its rank fewer kept elements."""
    images, anns, mask = synth_batch(2)
    variables = init_variables(1)
    _, cfg = configs(1)
    state = {k: v.numpy() for k, v in
             ckpt.state_dict_from_jax(variables, cfg).items()}
    return images, anns, mask, variables, state


def init_state(model_kw):
    """`init_reference_` weights (seed 0) of a model, as numpy."""
    from offsetguided_tpu_torch.config.defaults import (HeadsConfig,
                                                        ModelConfig)
    from offsetguided_tpu_torch.models import PoseNet
    from offsetguided_tpu_torch.models.network import init_reference_
    kw = dict(model_kw, heads=HeadsConfig(**model_kw.get('heads', {})))
    net = init_reference_(PoseNet(ModelConfig(**kw)),
                          torch.Generator().manual_seed(0))
    return {k: v.numpy() for k, v in net.state_dict().items()}


@pytest.fixture(scope='module')
def ranks():
    """Every 2-rank case in one spawn; each rank's results by case name."""
    preds, targets, mask = loss_inputs()
    images, anns, smask, _, state = step_inputs()
    step = dict(model_kw=TINY1, state=state, images=images, anns=anns,
                mask=smask)
    tower = dict(TINY1, heads=dict(tower=True, include_spread=True))
    cases = [('bn64', 'batchnorm', bn_inputs(np.float64, 0)),
             ('bn32', 'batchnorm', bn_inputs(np.float32, 1)),
             ('losses', 'losses', dict(preds=preds, targets=targets,
                                       mask=mask, loss_kw={})),
             ('step', 'train_step', step),
             ('guard', 'train_step', dict(step, spike_rank=1, spike=1e10)),
             ('remat', 'train_step', dict(step, model_kw=dict(TINY1,
                                                              remat=True))),
             ('tower', 'train_step', dict(step, model_kw=tower, steps=2,
                                          state=init_state(tower))),
             ('freeze', 'train_step', dict(step, **FREEZE))]
    return distributed.spawn(parity.run_cases, WORLD, cases, 'cpu', True, 1)


def whole_bn(inp):
    """The one-process layer on the whole batch."""
    x = torch.from_numpy(inp['x']).requires_grad_()
    bn = BatchNorm2d(x.shape[1]).to(x.dtype)
    with torch.no_grad():
        for k in ('weight', 'bias', 'running_mean', 'running_var'):
            getattr(bn, k).copy_(torch.from_numpy(inp[k]))
    bn.train()
    y = bn(x)
    y.backward(torch.from_numpy(inp['dy']))
    return dict(y=y.detach().numpy(), dx=x.grad.numpy(),
                dw=bn.weight.grad.numpy(), db=bn.bias.grad.numpy(),
                running_mean=bn.running_mean.numpy(),
                running_var=bn.running_var.numpy())


@pytest.mark.parametrize('case,dtype,seed,tol', [
    ('bn64', np.float64, 0, 1e-12), ('bn32', np.float32, 1, 2e-5)])
def test_synchronized_batchnorm_matches_the_whole_batch(ranks, case, dtype,
                                                        seed, tol):
    """Forward and `dx` of the two slices are the whole batch's; the
    ranks' `dw` / `db` shares add up to the whole batch's; the running
    statistics (fast, biased variance) are the whole batch's on both
    ranks."""
    want = whole_bn(bn_inputs(dtype, seed))
    got = [r[case] for r in ranks]
    for k in ('y', 'dx'):
        np.testing.assert_allclose(np.concatenate([g[k] for g in got]),
                                   want[k], rtol=tol, atol=tol, err_msg=k)
    for k in ('dw', 'db'):
        np.testing.assert_allclose(sum(g[k] for g in got), want[k],
                                   rtol=tol, atol=tol, err_msg=k)
    for k in ('running_mean', 'running_var'):
        for g in got:
            np.testing.assert_allclose(g[k], want[k], rtol=tol, atol=tol,
                                       err_msg=k)


def test_global_loss_normalizers(ranks):
    """Each rank's share over the global counts and batch: the shares add
    up to the whole batch's losses, every rank reports the whole batch's
    losses, and the gradients of the shares are the whole batch's
    gradient, slice for slice. A naive DDP mean (each rank normalized by
    its own counts and batch, then averaged) misses the whole batch's
    loss on this batch, whose halves keep different counts."""
    preds, targets, mask = loss_inputs()
    p = {k: [None if a is None else torch.from_numpy(a).requires_grad_()
             for a in v] for k, v in preds.items()}
    want = compute_losses(p, Targets(**{k: torch.from_numpy(v) for k, v in
                                        targets.items()}),
                          torch.from_numpy(mask), LossConfig())
    want['total'].backward()
    for k, v in want.items():
        w = float(v.detach())
        np.testing.assert_allclose(sum(r['losses']['local'][k]
                                       for r in ranks), w, rtol=1e-5,
                                   err_msg=k)
        for r in ranks:
            np.testing.assert_allclose(r['losses']['global'][k], w,
                                       rtol=1e-5, err_msg=k)
    for k, v in p.items():
        if v[0] is not None:
            np.testing.assert_allclose(
                np.concatenate([r['losses']['grads'][k][0] for r in ranks]),
                v[0].grad.numpy(), rtol=1e-4,
                atol=1e-6 * float(v[0].grad.abs().max()), err_msg=k)

    def half(i):
        sl = slice(2 * i, 2 * i + 2)
        return float(compute_losses(
            {k: [None if a is None else torch.from_numpy(a[sl]) for a in v]
             for k, v in preds.items()},
            Targets(**{k: torch.from_numpy(v[sl]) for k, v in
                       targets.items()}),
            torch.from_numpy(mask[sl]), LossConfig())['total'])
    naive = (half(0) + half(1)) / 2
    assert abs(naive - float(want['total'])) > 1e-3 * float(want['total'])


@pytest.fixture(scope='module')
def jax_mesh_step():
    """The JAX package's donated `jit_train_step` (SGD, lr 1e-3) on the
    one-step batch, sharded over a 2-device `data` axis."""
    images, anns, mask, variables, _ = step_inputs()
    jcfg, _ = configs(1)
    tx = jmake_optimizer(JTrainConfig(optimizer='sgd', learning_rate=1e-3))
    mesh = make_mesh(2, 1)
    jt, _ = targets_both(anns)
    state = jax.device_put(create_train_state(variables, tx),
                           replicated(mesh))
    batch = jax.device_put((jnp.asarray(images), jt, jnp.asarray(mask)),
                           batch_sharding(mesh))
    step = jit_train_step(JPoseNet(jcfg), tx,
                          JLossConfig(stack_weights=(1.0,)))
    with mesh:
        state, metrics = step(state, *batch)
    return (jax.tree_util.tree_map(np.asarray, state),
            {k: float(v) for k, v in metrics.items()})


def assert_one_step_close(before, got, want, lr=1e-3):
    """The one-step tolerances of `test_one_train_step_matches_jax`:
    gradients (the step over lr) within rtol 1e-3 and 1e-4 of the largest
    gradient."""
    gmax = max(np.abs(before[k] - want[k]).max() for k in before) / lr
    for k in before:
        np.testing.assert_allclose((before[k] - got[k]) / lr,
                                   (before[k] - want[k]) / lr, rtol=1e-3,
                                   atol=1e-4 * gmax, err_msg=k)


def test_two_rank_step_matches_jax_mesh_step(ranks, jax_mesh_step):
    """Two ranks' DDP step against JAX's step on the 2-device mesh:
    losses within 1e-4 relative, gradients at the one-step tolerances, BN
    statistics within 1e-5; the ranks end bit-equal."""
    jstate, jm = jax_mesh_step
    variables = step_inputs()[3]
    _, cfg = configs(1)
    assert ranks[0]['step']['digest'] == ranks[1]['step']['digest']
    m = ranks[0]['step']['metrics']
    for k in jm:
        np.testing.assert_allclose(m[k], jm[k], rtol=1e-4, err_msg=k)
    assert m['skipped'] == 0.0 and m['hmp'] > 0
    ours = ckpt.jax_from_state_dict(
        {k: torch.from_numpy(v) for k, v in
         ranks[1]['step']['state'].items()}, cfg)
    assert_one_step_close(flat(variables['params']), flat(ours['params']),
                          flat(jstate.params))
    want, got = flat(jstate.batch_stats), flat(ours['batch_stats'])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)


def assert_matches_one_rank_step(got):
    """A 2-rank `train_step` result against the same step in one process
    on the whole batch (no group, no remat): the same losses, gradients
    and BN statistics at the one-step tolerances."""
    images, anns, mask, variables, state = step_inputs()
    _, cfg = configs(1)
    _, tt = targets_both(anns)
    net, step = port_step(variables, cfg)
    m = step(torch.from_numpy(images), tt, torch.from_numpy(mask))
    for k, v in m.items():
        np.testing.assert_allclose(got['metrics'][k], float(v), rtol=1e-4,
                                   err_msg=k)
    one = net.state_dict()
    assert_one_step_close({k: v for k, v in state.items()
                           if k.endswith(('weight', 'bias'))},
                          got['state'], {k: one[k].numpy() for k in state})
    for k in state:
        if 'running' in k:
            np.testing.assert_allclose(got['state'][k], one[k].numpy(),
                                       rtol=0, atol=1e-5, err_msg=k)


def test_two_rank_step_matches_one_rank_step(ranks):
    """The same step in one process on the whole batch (no group): the
    same losses, gradients and BN statistics at the one-step
    tolerances."""
    assert_matches_one_rank_step(ranks[0]['step'])


def test_two_rank_remat_step_matches_one_rank_step(ranks):
    """The 2-rank step with `remat`: the checkpointed blocks' recompute
    in the backward issues the synchronized BatchNorm's forward
    all-reduce again (statistics frozen) between DDP's gradient
    all-reduces. The same losses, gradients and BN statistics (updated
    once) as the one-process step without remat, and the ranks end
    bit-equal."""
    assert ranks[0]['remat']['digest'] == ranks[1]['remat']['digest']
    assert ranks[0]['remat']['metrics']['skipped'] == 0.0
    assert_matches_one_rank_step(ranks[1]['remat'])


def test_two_rank_frozen_step_matches_one_rank_step(ranks):
    """`--freeze Hourglass104_0 --max-grad-norm`: the frozen parameters
    stay in DDP's reducer and their summed gradients are zeroed before
    the clip, so two ranks take the one-process step on the whole batch
    (the same losses, gradients and BN statistics at the one-step
    tolerances), the frozen weights bit-equal to their start and the
    ranks to each other."""
    images, anns, mask, _, state = step_inputs()
    one = parity.train_step('cpu', TINY1, state, images, anns, mask,
                            **FREEZE)
    got = ranks[0]['freeze']
    assert got['digest'] == ranks[1]['freeze']['digest']
    assert got['metrics']['skipped'] == 0.0
    for k, v in got['metrics'].items():
        np.testing.assert_allclose(v, one['metrics'][k], rtol=1e-4,
                                   err_msg=k)
    weights = {k: v for k, v in state.items()
               if k.endswith(('weight', 'bias'))}
    assert_one_step_close(weights, got['state'], one['state'])
    for k in state:
        if 'running' in k:
            np.testing.assert_allclose(got['state'][k], one['state'][k],
                                       rtol=0, atol=1e-5, err_msg=k)
    frozen = [k for k in weights if k.startswith('basenet.')]
    assert frozen
    for k in frozen:
        np.testing.assert_array_equal(got['state'][k], state[k], err_msg=k)
    assert any(not np.array_equal(got['state'][k], state[k])
               for k in weights if k.startswith('headnets.'))


def test_explosion_guard_skips_on_every_rank(ranks):
    """A 1e10 heatmap target in rank 1's slice alone: the global total
    passes the guard, so both ranks skip the step, report the global
    total, and keep their weights, bit-equal."""
    _, _, _, _, state = step_inputs()
    for r in ranks:
        m = r['guard']['metrics']
        assert m['skipped'] == 1.0 and m['total'] > 1e8
        for k, v in state.items():
            if k.endswith(('weight', 'bias')):
                np.testing.assert_array_equal(r['guard']['state'][k], v,
                                              err_msg=k)
    assert ranks[0]['guard']['digest'] == ranks[1]['guard']['digest']
    assert ranks[0]['guard']['metrics'] == ranks[1]['guard']['metrics']


def test_local_slice_and_identity_without_a_group():
    """Without a process group every helper is the identity: one
    process, rank 0, the whole batch, sums unchanged."""
    assert not distributed.active() and distributed.group() is None
    assert (distributed.rank(), distributed.world()) == (0, 1)
    assert distributed.is_primary()
    batch = {'image': np.arange(8).reshape(4, 2), 'metas': list('abcd'),
             'epoch': 3}
    assert distributed.local_batch(batch) is batch
    t = torch.ones(3)
    assert distributed.all_reduce_sum(t) is t and float(t.sum()) == 3.0
    distributed.barrier()


def test_unused_spread_tower_steps_twice(ranks):
    """3x3 tower heads with a spread tower the offset loss leaves out:
    `data_parallel` searches for unused parameters, so a second step runs
    (DDP would stop it otherwise); finite losses, the spread tower
    unchanged, the ranks bit-equal."""
    init = init_state(dict(TINY1, heads=dict(tower=True,
                                              include_spread=True)))
    got = ranks[0]['tower']
    assert got['metrics']['skipped'] == 0.0
    assert np.isfinite(got['metrics']['total'])
    spread = [k for k in init if 'spread_convs' in k]
    assert spread and all(np.array_equal(got['state'][k], init[k])
                          for k in spread)
    assert ranks[0]['tower']['digest'] == ranks[1]['tower']['digest']
