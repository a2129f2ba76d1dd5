"""The port's training path against the JAX package's, on the CPU at the
JAX CLI's `--debug-tiny-model` widths (hg_order 2, dims (16, 16, 24),
modules (1, 1, 1), cnv_dim 16, fp32): train-mode BatchNorm, optimizer
updates and LR schedules, one train step, the explosion guard; and, on the
port alone, the loss falling over 30 steps, remat, checkpoints and the
training CLI."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from offsetguided_tpu.config import COCO_PERSON_SIGMAS, COCO_PERSON_SKELETON
from offsetguided_tpu.config.defaults import EncoderConfig as JEncoderConfig
from offsetguided_tpu.config.defaults import HeadsConfig as JHeadsConfig
from offsetguided_tpu.config.defaults import LossConfig as JLossConfig
from offsetguided_tpu.config.defaults import ModelConfig as JModelConfig
from offsetguided_tpu.config.defaults import TrainConfig as JTrainConfig
from offsetguided_tpu.models import PoseNet as JPoseNet
from offsetguided_tpu.ops.encoder import encode_targets as jencode_targets
from offsetguided_tpu.parallel import create_train_state
from offsetguided_tpu.parallel import make_optimizer as jmake_optimizer
from offsetguided_tpu.parallel import make_train_step as jmake_train_step
from offsetguided_tpu.parallel import train_step as jtrain_step
from offsetguided_tpu_torch.cli import train as train_cli
from offsetguided_tpu_torch.config.defaults import (EncoderConfig,
                                                    HeadsConfig, LossConfig,
                                                    ModelConfig, TrainConfig)
from offsetguided_tpu_torch.data.synthetic import make_hard_dataset
from offsetguided_tpu_torch.models import PoseNet, state_dict_from_jax
from offsetguided_tpu_torch.models import checkpoint as ckpt
from offsetguided_tpu_torch.models.layers import BatchNorm2d
from offsetguided_tpu_torch.models.network import init_reference_
from offsetguided_tpu_torch.ops.encoder import encode_targets
from offsetguided_tpu_torch.ops.image import normalize_images
from offsetguided_tpu_torch.parallel.train_step import (
    TrainStep, clip_by_global_norm_, cyclic_lr_schedule, make_eval_step,
    make_optimizer, step_lr_schedule)

# the suite's worker processes share the host's cores
torch.set_num_threads(2)

TINY = dict(hg_order=2, dims=(16, 16, 24), modules=(1, 1, 1), cnv_dim=16,
            compute_dtype='float32')
# the forward tolerance of tests/test_converter_numeric.py: fp32
# convolutions summed in another order by XLA and by PyTorch's CPU kernels
RTOL, ATOL = 2e-3, 2e-4
SIZE = 64


def configs(n_stacks):
    return (JModelConfig(n_stacks=n_stacks, heads=JHeadsConfig(), **TINY),
            ModelConfig(n_stacks=n_stacks, heads=HeadsConfig(), **TINY))


def synth_batch(seed, batch=2):
    """uint8 images, (N, 4, 17, 4) annotations of two persons and a mask
    with a masked band, as tests/test_train.py builds them."""
    rng = np.random.RandomState(seed)
    anns = np.zeros((batch, 4, 17, 4), np.float32)
    anns[:, :2, :, :2] = rng.rand(batch, 2, 17, 2) * SIZE
    anns[:, :2, :, 2] = 2.0
    anns[:, :2, :, 3] = 5.0
    images = (rng.rand(batch, SIZE, SIZE, 3) * 255).astype(np.uint8)
    mask = np.ones((batch, SIZE // 4, SIZE // 4, 1), bool)
    mask[0, :3] = False
    return images, anns, mask


def targets_both(anns):
    out = SIZE // 4
    return (jencode_targets(jnp.asarray(anns), np.asarray(COCO_PERSON_SIGMAS),
                            COCO_PERSON_SKELETON, out, out,
                            JEncoderConfig(max_persons=4)),
            encode_targets(anns, COCO_PERSON_SIGMAS, COCO_PERSON_SKELETON,
                           out, out, EncoderConfig(max_persons=4)))


def init_variables(n_stacks, seed=0):
    """The tiny model's variables as a JAX tree, from the port's reference
    init (`jax_from_state_dict`; `test_jax_tree_roundtrip` holds the tree
    equal to the JAX model's own). The JAX init itself costs ~20 s eagerly
    and as long to compile at 2 stacks."""
    _, cfg = configs(n_stacks)
    net = init_reference_(PoseNet(cfg), torch.Generator().manual_seed(seed))
    return ckpt.jax_from_state_dict(net.state_dict(), cfg)


def tamed_variables(jcfg, seed):
    """JAX variables with seeded random values: He-scaled kernels, running
    variances >= 0.5, so the train-mode statistics differ from them."""
    v = init_variables(jcfg.n_stacks)
    rng = np.random.RandomState(seed)

    def draw(path, x):
        x = np.asarray(x)
        if x.ndim == 4:
            return (rng.randn(*x.shape) / np.sqrt(np.prod(x.shape[:3]))
                    ).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return (np.abs(rng.randn(*x.shape)) + 0.5).astype(np.float32)
        return (0.5 * rng.randn(*x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, v)


def flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_train_mode_batchnorm_matches_jax():
    """One train-mode forward from JAX weights: outputs within the forward
    tolerance, and the running mean and (biased) variance after the step
    within 1e-5 of flax's."""
    jcfg, cfg = configs(2)
    variables = tamed_variables(jcfg, 0)
    x = normalize_images(torch.from_numpy(synth_batch(1)[0]))
    apply = jax.jit(functools.partial(JPoseNet(jcfg).apply, train=True,
                                      mutable=['batch_stats']))
    ref, mutated = apply(variables, jnp.asarray(x.numpy()))
    net = PoseNet(cfg)
    net.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    net.train()
    with torch.no_grad():
        ours = net(x)
    for key in ('hmp', 'omp', 'scmp'):
        for s in range(2):
            np.testing.assert_allclose(ours[key][s].numpy(),
                                       np.asarray(ref[key][s]), rtol=RTOL,
                                       atol=ATOL, err_msg=f'{key} {s}')
    got = flat(ckpt.jax_from_state_dict(net.state_dict(), cfg)['batch_stats'])
    want = flat(mutated['batch_stats'])
    assert got.keys() == want.keys() and len(want) > 50
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    moved = flat(variables['batch_stats'])
    assert max(np.abs(want[k] - moved[k]).max() for k in want) > 1e-2


def test_batchnorm_stores_the_biased_variance():
    """The running variance moves by 0.1 * the biased batch variance (the
    stock layer would store n/(n-1) of it); eval mode is the stock layer."""
    bn = BatchNorm2d(3)
    bn.momentum = 0.1
    x = torch.randn(2, 3, 2, 2, dtype=torch.float32)
    bn.train()
    y = bn(x)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    torch.testing.assert_close(y.mean(dim=(0, 2, 3)), torch.zeros(3),
                               atol=1e-6, rtol=0)
    bn.eval()
    ref = torch.nn.functional.batch_norm(x, bn.running_mean, bn.running_var,
                                         bn.weight, bn.bias, False, 0.0,
                                         bn.eps)
    torch.testing.assert_close(bn(x), ref)


OPTIMIZERS = {
    'adam': dict(optimizer='adam'),
    'adam_bf16_moments': dict(optimizer='adam', opt_state_dtype='bfloat16'),
    'sgd_momentum': dict(optimizer='sgd', momentum=0.9),
    'adam_weight_decay': dict(optimizer='adam', weight_decay=0.01),
    'sgd_weight_decay': dict(optimizer='sgd', weight_decay=0.01),
}


@pytest.mark.parametrize('name', sorted(OPTIMIZERS))
def test_optimizer_updates_match_optax(name):
    """Five steps from identical gradient arrays (of mixed scales, so
    Adam's sign-like first step does not hide an error), each at the step
    schedule's LR: parameters within 1e-6."""
    kw = dict(OPTIMIZERS[name], learning_rate=1e-2, warmup_epochs=1,
              lr_drop_epochs=(2,))
    rng = np.random.RandomState(0)
    shapes = {'a': (4, 3), 'b': (7,), 'c': (2, 2, 3, 3)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 10.0 ** rng.randint(-3, 2, s)).astype(
        np.float32) for k, s in shapes.items()} for _ in range(5)]

    jsched = jtrain_step.step_lr_schedule(JTrainConfig(**kw), 2)
    tx = jmake_optimizer(JTrainConfig(**kw), jsched)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = make_optimizer(TrainConfig(**kw), list(tp.values()))
    sched = step_lr_schedule(TrainConfig(**kw), 2)
    for i, g in enumerate(grads):
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for group in opt.param_groups:
            group['lr'] = sched(i)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0, atol=1e-6,
                                       err_msg=f'{name} step {i} {k}')


@pytest.mark.parametrize('max_norm', [0.5, 1e3])
def test_global_norm_clip_matches_optax(max_norm):
    """`--max-grad-norm`: above the norm every gradient is scaled to it,
    below it they pass unchanged."""
    rng = np.random.RandomState(1)
    grads = [rng.randn(*s).astype(np.float32) for s in ((4, 3), (7,), (2, 5))]
    ref, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], None)
    ours = [torch.from_numpy(g.copy()) for g in grads]
    clip_by_global_norm_(ours, max_norm)
    for a, b in zip(ref, ours):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)


def test_lr_schedules_match_jax():
    """Both schedules at step 0, the warm-up's end and each drop."""
    kw = dict(learning_rate=1.25e-4, warmup_epochs=2,
              lr_drop_epochs=(5, 8, 11), lr_drop_factor=0.2)
    spe = 7
    steps = [0, 1, 2 * spe - 1, 2 * spe, 5 * spe - 1, 5 * spe, 8 * spe,
             11 * spe, 11 * spe + 3, 30 * spe]
    for ours, ref in (
            (step_lr_schedule(TrainConfig(**kw), spe),
             jtrain_step.step_lr_schedule(JTrainConfig(**kw), spe)),
            (cyclic_lr_schedule(TrainConfig(**kw), spe, 3, 0.2),
             jtrain_step.cyclic_lr_schedule(JTrainConfig(**kw), spe, 3,
                                            0.2))):
        for s in steps:
            np.testing.assert_allclose(ours(s), float(ref(s)), rtol=1e-6)


@pytest.fixture(scope='module')
def jax_sgd_step():
    """The JAX package's jitted train step with SGD, compiled once."""
    jcfg, _ = configs(1)
    tx = jmake_optimizer(JTrainConfig(optimizer='sgd', learning_rate=1e-3))
    return tx, jax.jit(jmake_train_step(JPoseNet(jcfg), tx,
                                        JLossConfig(stack_weights=(1.0,))))


def port_step(variables, cfg, lr=1e-3, **loss_kw):
    net = PoseNet(cfg)
    net.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    opt = make_optimizer(TrainConfig(optimizer='sgd', learning_rate=lr),
                         net.parameters())
    return net, TrainStep(net, opt, LossConfig(stack_weights=(1.0,),
                                               **loss_kw))


def test_one_train_step_matches_jax(jax_sgd_step):
    """One SGD step (lr 1e-3, momentum 0.9: the step is lr * gradient) of
    the one-stack tiny model from the trainer's initial weights: losses
    within 1e-4 relative, gradients within rtol 1e-3 (atol 1e-4 of the
    largest gradient: BatchNorm scale gradients are sums that cancel), BN
    statistics within 1e-5."""
    tx, jstep = jax_sgd_step
    jcfg, cfg = configs(1)
    images, anns, mask = synth_batch(2)
    jt, tt = targets_both(anns)
    variables = init_variables(1)
    state, jm = jstep(create_train_state(variables, tx), jnp.asarray(images),
                      jt, jnp.asarray(mask))
    net, step = port_step(variables, cfg)
    m = step(torch.from_numpy(images), tt, torch.from_numpy(mask))
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    assert float(m['skipped']) == 0.0 and float(m['hmp']) > 0

    before = flat(variables['params'])
    after = flat(jax.tree_util.tree_map(np.asarray, state.params))
    ours = ckpt.jax_from_state_dict(net.state_dict(), cfg)
    got = flat(ours['params'])
    gmax = max(np.abs(before[k] - after[k]).max() for k in before) / 1e-3
    for k in before:
        np.testing.assert_allclose((before[k] - got[k]) / 1e-3,
                                   (before[k] - after[k]) / 1e-3, rtol=1e-3,
                                   atol=1e-4 * gmax, err_msg=k)
    want = flat(jax.tree_util.tree_map(np.asarray, state.batch_stats))
    got = flat(ours['batch_stats'])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)


def test_eval_step_matches_jax():
    """Validation losses with the running statistics, from JAX weights."""
    jcfg, cfg = configs(2)
    variables = tamed_variables(jcfg, 4)
    images, anns, mask = synth_batch(7)
    jt, tt = targets_both(anns)
    ref = jax.jit(jtrain_step.make_eval_step(JPoseNet(jcfg), JLossConfig(
        stack_weights=(1.0, 1.0))))(
        create_train_state(variables, jmake_optimizer(JTrainConfig())),
        jnp.asarray(images), jt, jnp.asarray(mask))
    net = PoseNet(cfg)
    net.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    ours = make_eval_step(net, LossConfig(stack_weights=(1.0, 1.0)))(
        torch.from_numpy(images), tt, torch.from_numpy(mask))
    for k in ref:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-4,
                                   err_msg=k)
    assert not net.training


@pytest.mark.parametrize('target', [1e10, 1e30])
def test_explosion_guard_skips_on_both_sides(jax_sgd_step, target):
    """A huge heatmap target on a labeled texel: at 1e10 the total passes
    the 1e8 guard, at 1e30 it overflows to inf. Both steps record
    `skipped`; the port leaves the parameters as they were (zero gradients
    into a fresh momentum), and so does the JAX step where its gradients
    are finite (at 1e30 it multiplies NaN gradients by 0 and keeps NaN)."""
    tx, jstep = jax_sgd_step
    jcfg, cfg = configs(1)
    images, anns, mask = synth_batch(3)
    jt, tt = targets_both(anns)
    jt = jt._replace(hmp=jt.hmp.at[1, 5, 5, 3].set(target))
    tt.hmp[1, 5, 5, 3] = target
    variables = init_variables(1, seed=1)
    state, jm = jstep(create_train_state(variables, tx), jnp.asarray(images),
                      jt, jnp.asarray(mask))
    net, step = port_step(variables, cfg)
    m = step(torch.from_numpy(images), tt, torch.from_numpy(mask))
    assert float(jm['skipped']) == float(m['skipped']) == 1.0
    assert np.isfinite(float(m['total'])) == (target < 1e20)
    before = flat(variables['params'])
    got = flat(ckpt.jax_from_state_dict(net.state_dict(), cfg)['params'])
    ref = flat(jax.tree_util.tree_map(np.asarray, state.params))
    for k in before:
        np.testing.assert_array_equal(got[k], before[k], err_msg=k)
        if target < 1e20:
            np.testing.assert_array_equal(ref[k], before[k], err_msg=k)


def fresh_model(cfg, seed=0):
    return init_reference_(PoseNet(cfg), torch.Generator().manual_seed(seed))


def test_loss_falls_over_30_steps():
    """As tests/test_train.py: 30 Adam steps on one batch take the heatmap
    loss below 0.7 of its first value."""
    _, cfg = configs(1)
    images, anns, mask = synth_batch(4)
    _, tt = targets_both(anns)
    net = fresh_model(cfg)
    opt = make_optimizer(TrainConfig(learning_rate=3e-4), net.parameters())
    step = TrainStep(net, opt, LossConfig(stack_weights=(1.0,)))
    hist = [step(torch.from_numpy(images), tt, torch.from_numpy(mask))
            for _ in range(30)]
    first, last = hist[0], hist[-1]
    assert np.isfinite(float(first['total'])) and np.isfinite(
        float(last['total']))
    assert float(last['hmp']) < 0.7 * float(first['hmp'])
    assert float(last['total']) < float(first['total'])
    assert all(float(h['skipped']) == 0.0 for h in hist)


def test_reference_init():
    """normal(0, 0.001) kernels, zero biases, identity BatchNorm; the same
    weights for a seed."""
    _, cfg = configs(1)
    a, b = fresh_model(cfg, 3), fresh_model(cfg, 3)
    for (n, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), n
    w = torch.cat([m.weight.detach().reshape(-1) for m in a.modules()
                   if isinstance(m, torch.nn.Conv2d)])
    assert abs(float(w.std()) - 1e-3) < 1e-4
    for m in a.modules():
        if isinstance(m, torch.nn.Conv2d) and m.bias is not None:
            assert not m.bias.any()
        if isinstance(m, BatchNorm2d):
            assert (m.weight == 1).all() and not m.bias.any()
            assert (m.running_var == 1).all() and not m.running_mean.any()
            assert abs(m.momentum - 0.1) < 1e-12


def test_remat_matches_plain():
    """`remat` recomputes each stack in the backward: the same losses,
    gradients and BatchNorm statistics (each batch counted once)."""
    _, cfg = configs(2)
    images, anns, mask = synth_batch(5)
    _, tt = targets_both(anns)
    out = []
    for remat in (False, True):
        net = fresh_model(dataclasses.replace(cfg, remat=remat))
        opt = make_optimizer(TrainConfig(optimizer='sgd', learning_rate=1e-3),
                             net.parameters())
        m = TrainStep(net, opt, LossConfig(stack_weights=(1.0, 1.0)))(
            torch.from_numpy(images), tt, torch.from_numpy(mask))
        out.append((m, net.state_dict()))
    (m0, sd0), (m1, sd1) = out
    assert float(m0['total']) == pytest.approx(float(m1['total']), rel=1e-6)
    for k in sd0:
        torch.testing.assert_close(sd1[k], sd0[k], rtol=1e-5, atol=1e-7,
                                   msg=k)


def test_bf16_autocast_train_step_runs():
    """The default compute policy (bf16 backbone, fp32 parameters and
    statistics) trains on the CPU too."""
    _, cfg = configs(1)
    cfg = dataclasses.replace(cfg, compute_dtype='bfloat16')
    images, anns, mask = synth_batch(6)
    _, tt = targets_both(anns)
    net = fresh_model(cfg)
    step = TrainStep(net, make_optimizer(TrainConfig(), net.parameters()),
                     LossConfig(stack_weights=(1.0,)))
    m = step(torch.from_numpy(images), tt, torch.from_numpy(mask))
    assert np.isfinite(float(m['total']))
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert all(b.dtype == torch.float32 for n, b in net.named_buffers()
               if 'running' in n)


def test_jax_tree_roundtrip():
    """`jax_from_state_dict` gives the JAX model's own tree (structure,
    shapes) and inverts `state_dict_from_jax`."""
    jcfg, cfg = configs(2)
    ref = jax.eval_shape(functools.partial(JPoseNet(jcfg).init, train=False),
                         jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    ours = init_variables(2)
    assert jax.tree_util.tree_structure(ours) == \
        jax.tree_util.tree_structure(ref)
    shapes = {jax.tree_util.keystr(k): v.shape
              for k, v in jax.tree_util.tree_leaves_with_path(ref)}
    assert {k: v.shape for k, v in flat(ours).items()} == shapes
    variables = tamed_variables(jcfg, 7)
    back = ckpt.jax_from_state_dict(state_dict_from_jax(variables, cfg), cfg)
    for k, v in flat(variables).items():
        np.testing.assert_array_equal(flat(back)[k], v, err_msg=k)


@pytest.fixture(scope='module')
def tiny_set(tmp_path_factory):
    return make_hard_dataset(str(tmp_path_factory.mktemp('train')),
                             n_images=4, seed=1, ext='npy')


def cli_args(tiny_set, ckpt_dir, *extra):
    img_dir, ann = tiny_set
    return ['--device', 'cpu', '--device-aug', '--debug-tiny-model',
            '--train-image-dir', img_dir, '--train-annotations', ann,
            '--batch-size', '2', '--square-length', '128', '--max-persons',
            '12', '--print-freq', '1', '--checkpoint-dir', str(ckpt_dir),
            *extra]


def test_cli_trains_and_resumes(tiny_set, tmp_path):
    """Two steps on the CPU write a checkpoint; `load_checkpoint` restores
    that model and optimizer state exactly, and `--resume` goes on from
    the step it saved."""
    r = train_cli.main(cli_args(tiny_set, tmp_path, '--max-steps', '2'))
    assert r['steps'] == 2 and len(r['history']) == 2
    assert all(np.isfinite(h['total']) and h['skipped'] == 0.0
               for h in r['history'])
    path = ckpt.latest_checkpoint(str(tmp_path))
    assert path == r['checkpoint']
    saved = torch.load(path, weights_only=False)
    assert saved['step'] == 2

    cfg = train_cli.model_config(train_cli.cli(cli_args(tiny_set, tmp_path)),
                                 HeadsConfig())
    net = PoseNet(cfg)
    opt = make_optimizer(TrainConfig(), net.parameters())
    step, epoch, _ = ckpt.load_checkpoint(path, net, opt)
    assert (step, epoch) == (2, 0)
    for k, v in saved['model'].items():
        assert torch.equal(net.state_dict()[k], v), k
    st = opt.state_dict()['state']
    assert st.keys() == saved['optimizer']['state'].keys() and st
    for i in st:
        for k in ('exp_avg', 'exp_avg_sq'):
            assert torch.equal(st[i][k], saved['optimizer']['state'][i][k])
    assert ckpt.load_checkpoint(path, net, opt, drop_optimizer=True,
                                recount_epoch=True)[:2] == (0, 0)

    r2 = train_cli.main(cli_args(tiny_set, tmp_path / 'more', '--resume',
                                 path, '--max-steps', '1'))
    assert torch.load(r2['checkpoint'], weights_only=False)['step'] == 3


@pytest.fixture(scope='module')
def host_run(tiny_set, tmp_path_factory):
    """Three host-route steps over an epoch of two with the validation
    pass at the epoch end."""
    img_dir, ann = tiny_set
    argv = [a for a in cli_args(tiny_set, tmp_path_factory.mktemp('host'),
                                '--max-steps', '3', '--val-image-dir',
                                img_dir, '--val-annotations', ann)
            if a != '--device-aug']
    assert not train_cli.cli(argv).device_aug
    return train_cli.main(argv)


def test_cli_trains_host_route_with_validation(host_run):
    """The default (host augmentation) route with --val-*: three steps
    over an epoch of two, the validation pass at the epoch end (two
    unaugmented batches, a finite loss), finite losses, a checkpoint."""
    r = host_run
    assert r['steps'] == 3 and len(r['history']) == 3
    assert all(np.isfinite(h['total']) and h['skipped'] == 0.0
               for h in r['history'])
    assert len(r['val']) == 1 and r['val'][0]['epoch'] == 1
    assert r['val'][0]['batches'] == 2 and np.isfinite(r['val'][0]['loss'])
    assert torch.load(r['checkpoint'], weights_only=False)['step'] == 3


def test_cli_trains_with_loader_workers_and_resumes(tiny_set, tmp_path,
                                                     host_run):
    """--loader-workers 2: the same losses as the one-thread loader (the
    first two steps of `host_run`, before its validation pass), and a
    resume from the checkpoint goes on from its step."""
    argv = [a for a in cli_args(tiny_set, tmp_path / 'b', '--max-steps', '2',
                                '--loader-workers', '2')
            if a != '--device-aug']
    par = train_cli.main(argv)
    assert [h['total'] for h in par['history']] == \
        [h['total'] for h in host_run['history'][:2]]
    argv = [a for a in cli_args(tiny_set, tmp_path / 'c', '--max-steps', '1',
                                '--loader-workers', '2', '--resume',
                                par['checkpoint'])
            if a != '--device-aug']
    r = train_cli.main(argv)
    assert torch.load(r['checkpoint'], weights_only=False)['step'] == 3


def test_cli_trains_one_step_on_the_tiled_warp(tiny_set, tmp_path,
                                              monkeypatch):
    """The device-aug route defaults to the tiled warp, as the JAX trainer
    does, at the trainer's slope bound (`warp_slope_bound` of its
    augmentation flags); one CPU step on it gives finite losses and no
    skipped step. (The tiled warp against the patch warp and JAX's:
    tests/test_torch_port_warp_tiled.py.)"""
    from offsetguided_tpu_torch.ops import augment
    calls = []
    tiled = augment.affine_sample_tiled
    monkeypatch.setattr(augment, 'affine_sample_tiled', lambda *a, **kw: (
        calls.append(kw['slope_bound']), tiled(*a, **kw))[1])
    argv = cli_args(tiny_set, tmp_path, '--max-steps', '1')
    assert train_cli.cli(argv).warp_impl == 'tiled'
    h = train_cli.main(argv)['history'][0]
    assert h['skipped'] == 0.0
    assert all(np.isfinite(h[k]) for k in ('total', 'hmp', 'omp'))
    assert calls and set(calls) == {np.sqrt(2.0) / (0.5 * 0.95)}
