"""Fine-tuning in the port against the JAX package, on the CPU at tiny
widths: the `--freeze` selection (JAX `freeze_mask`), `load_checkpoint`
with `--drop-layers` and across a COCO -> CrowdPose head swap (JAX's orbax
`load_checkpoint`), `load_reference_into` (JAX `convert_torch_state_dict`)
on a full, a bare-backbone, a COCO-into-CrowdPose and an extra-key file,
one train step with `--freeze` and `--max-grad-norm` (JAX's optax chain),
and the CLIs: a frozen warm start, a resume with `--drop-layers`, and
`cli/evaluate.py --checkpoint` of its output. At most one JAX compile a
test."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from offsetguided_tpu.config.defaults import HeadsConfig as JHeadsConfig
from offsetguided_tpu.config.defaults import LossConfig as JLossConfig
from offsetguided_tpu.config.defaults import ModelConfig as JModelConfig
from offsetguided_tpu.config.defaults import TrainConfig as JTrainConfig
from offsetguided_tpu.models import PoseNet as JPoseNet
from offsetguided_tpu.models import checkpoint as jckpt
from offsetguided_tpu.parallel import create_train_state
from offsetguided_tpu.parallel import make_optimizer as jmake_optimizer
from offsetguided_tpu.parallel import make_train_step as jmake_train_step
from offsetguided_tpu_torch.cli import evaluate
from offsetguided_tpu_torch.cli import train as train_cli
from offsetguided_tpu_torch.config.defaults import (HeadsConfig, LossConfig,
                                                    ModelConfig, TrainConfig)
from offsetguided_tpu_torch.data.synthetic import make_hard_dataset
from offsetguided_tpu_torch.models import PoseNet, state_dict_from_jax
from offsetguided_tpu_torch.models import checkpoint as ckpt
from offsetguided_tpu_torch.parallel.train_step import (TrainStep,
                                                        make_optimizer)
from test_torch_port_train import (configs, flat, init_variables,
                                   synth_batch, targets_both)

# the suite's worker processes share the host's cores
torch.set_num_threads(2)

NARROW = dict(n_stacks=1, hg_order=2, dims=(8, 8, 12), modules=(1, 1, 1),
              cnv_dim=8, compute_dtype='float32')
COCO, CROWDPOSE = dict(n_keypoints=17, n_limbs=19), dict(n_keypoints=14,
                                                          n_limbs=17)


def narrow(heads=COCO, basenet='hourglass104'):
    kw = dict(NARROW, basenet=basenet)
    if basenet == 'hourglass4stage':
        kw = dict(basenet=basenet, n_stacks=1, compute_dtype='float32')
    return (JModelConfig(heads=JHeadsConfig(**heads), **kw),
            ModelConfig(heads=HeadsConfig(**heads), **kw))


def seeded_variables(jcfg, seed):
    """JAX variables of `jcfg` with seeded values on the tree of its init
    (no compile: the shapes only)."""
    shapes = jax.eval_shape(lambda: JPoseNet(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: rng.randn(*x.shape).astype(np.float32), shapes)


def port_model(variables, cfg):
    net = PoseNet(cfg)
    net.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return net


def jflat(tree):
    return jckpt._flatten(jax.tree_util.tree_map(np.asarray, tree))


def assert_leaves_equal(net, cfg, jvariables):
    """`net`'s weights as the JAX tree, bit-equal to `jvariables`."""
    ours = ckpt.jax_from_state_dict(net.state_dict(), cfg)
    for col in ('params', 'batch_stats'):
        want, got = jflat(jvariables[col]), jflat(ours[col])
        assert got.keys() == want.keys(), col
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def flax_paths(cfg):
    """Torch parameter name -> its JAX parameter path."""
    return {tk: fk for col, fk, tk, _, _ in ckpt.key_map(cfg)
            if col == 'params'}


REGEXES = ['Hourglass104_0', 'Hourglass4Stage_0', 'PoseHeads_0', 'omp_',
           'no_such_layer']


@pytest.mark.parametrize('regex', REGEXES)
@pytest.mark.parametrize('basenet', ['hourglass104', 'hourglass4stage'])
def test_freeze_selection_equals_freeze_mask(basenet, regex):
    """(a) `--freeze` freezes exactly the parameters JAX's `freeze_mask`
    marks untrainable."""
    jcfg, cfg = narrow(basenet=basenet)
    shapes = jax.eval_shape(lambda: JPoseNet(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    mask = jckpt._flatten(jckpt.freeze_mask(shapes['params'], regex))
    want = {k for k, trainable in mask.items() if not trainable}
    net = PoseNet(cfg)
    paths = flax_paths(cfg)
    got = {paths[n] for n in ckpt.frozen_parameters(net, regex)}
    assert got == want
    assert set(mask) == {paths[n] for n, _ in net.named_parameters()}
    assert bool(want) == (regex not in ('no_such_layer', {
        'hourglass104': 'Hourglass4Stage_0',
        'hourglass4stage': 'Hourglass104_0'}[basenet]))


def save_both(tmp_path, jcfg, cfg, variables, step=5, epoch=2):
    """One state saved by each package: JAX's orbax checkpoint, and the
    port's `save_checkpoint` of the same weights with the Adam moments of
    one step."""
    tx = jmake_optimizer(JTrainConfig())
    jstate = create_train_state(variables, tx)._replace(
        step=jnp.asarray(step, jnp.int32))
    jpath = jckpt.save_checkpoint(str(tmp_path / 'jax'), jstate, epoch, 1.5)
    net = port_model(variables, cfg)
    opt = make_optimizer(TrainConfig(), net.parameters())
    for p in net.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    net.load_state_dict(state_dict_from_jax(variables, cfg))   # the moments
    path = ckpt.save_checkpoint(str(tmp_path / 'port'), net, opt, step,
                                epoch, 1.5)
    return tx, jpath, path


@pytest.mark.parametrize('case', ['drop_omp', 'coco_into_crowdpose'])
def test_load_checkpoint_merges_leaf_by_leaf_as_jax(tmp_path, case):
    """(b) `load_checkpoint` (`--resume`) with `--drop-layers omp_`, and a
    COCO checkpoint resumed into CrowdPose heads (`--drop-optim-state`):
    from the same saved weights into the same fresh init, every leaf
    equals JAX's orbax `load_checkpoint`'s, bit for bit, and so do the
    step and epoch. Across the head swap without `--drop-optim-state` the
    JAX state keeps Adam moments of the old shapes (its first step fails
    on them); the port refuses, naming the flag."""
    jsrc, src = narrow()
    jdst, dst = narrow(CROWDPOSE if case == 'coco_into_crowdpose' else COCO)
    saved = seeded_variables(jsrc, 1)
    fresh = seeded_variables(jdst, 2)
    tx, jpath, path = save_both(tmp_path, jsrc, src, saved)
    drop = dict(drop_layers='omp_') if case == 'drop_omp' else dict(
        drop_optimizer=True)
    jstate, jepoch, _ = jckpt.load_checkpoint(
        jpath, create_train_state(fresh, tx), **drop)
    net = port_model(fresh, dst)
    opt = make_optimizer(TrainConfig(), net.parameters())
    step, epoch, _ = ckpt.load_checkpoint(path, net, opt, **drop)
    assert (step, epoch) == (int(jstate.step), jepoch)
    assert_leaves_equal(net, dst, {'params': jstate.params,
                                   'batch_stats': jstate.batch_stats})
    kept = [k for k, v in jflat(jstate.params).items()
            if np.array_equal(v, jflat(fresh['params'])[k])]
    assert kept and all('omp_' in k or 'PoseHeads_0' in k for k in kept)
    if case == 'drop_omp':
        assert opt.state_dict()['state']          # the moments restored
    else:
        net = port_model(fresh, dst)
        opt = make_optimizer(TrainConfig(), net.parameters())
        with pytest.raises(ValueError, match='--drop-optim-state'):
            ckpt.load_checkpoint(path, net, opt)


def reference_files(tmp_path):
    """The JAX package's `save_torch_checkpoint` of seeded COCO weights, as
    written, as a bare backbone (the pretrained hourglass's keys), and
    with a ConvBN conv bias and a key the map does not name."""
    jcfg, _ = narrow()
    path = str(tmp_path / 'full.pth')
    jckpt.save_torch_checkpoint(path, seeded_variables(jcfg, 3), jcfg)
    sd = torch.load(path, weights_only=False)['model_state_dict']
    bare = {k[len('basenet.'):]: v for k, v in sd.items()
            if k.startswith('basenet.')}
    extra = dict(sd, **{'basenet.pre.0.conv.bias': torch.ones(
        sd['basenet.pre.0.conv.weight'].shape[0]), 'extra.weight':
        torch.ones(3)})
    files = {'full': path}
    for name, d in (('bare_backbone', bare), ('extra_key', extra)):
        files[name] = str(tmp_path / f'{name}.pth')
        torch.save({'epoch': 0, 'model_state_dict': d}, files[name])
    return files


@pytest.mark.parametrize('case', ['full', 'bare_backbone', 'extra_key',
                                  'coco_into_crowdpose'])
def test_load_reference_into_equals_convert_torch_state_dict(tmp_path, case):
    """(c) `load_reference_into` (`--torch-checkpoint` in every CLI) gives
    JAX's `load_torch_checkpoint` leaves bit for bit from the same fresh
    init, and its unmatched list, entry for entry."""
    files = reference_files(tmp_path)
    jcfg, cfg = narrow(CROWDPOSE if case == 'coco_into_crowdpose' else COCO)
    fresh = seeded_variables(jcfg, 4)
    path = files['full' if case == 'coco_into_crowdpose' else case]
    converted, missing = jckpt.load_torch_checkpoint(path, fresh, jcfg)
    net = port_model(fresh, cfg)
    unmatched = ckpt.load_reference_into(net, path)
    assert unmatched == missing
    assert_leaves_equal(net, cfg, converted)
    n = {'full': 0, 'extra_key': 1}.get(case)
    assert n is None and unmatched or len(unmatched) == n


@pytest.mark.parametrize('weight_decay', [0.0, 1e-2])
def test_frozen_step_matches_the_optax_chain(weight_decay):
    """(d) One SGD step with `--freeze Hourglass104_0 --max-grad-norm`,
    against the chain JAX's trainer builds (`masked(set_to_zero)`, then
    `clip_by_global_norm`, weight decay, SGD): the clip binds, on the
    trainable gradients' norm; every parameter within the one-step
    tolerances (rtol 1e-3, atol 1e-4 of the largest update); the frozen
    ones bit-equal to their start at weight decay 0, moved by the decay
    alone otherwise; the frozen layers' BatchNorm statistics updated."""
    jcfg, cfg = configs(1)
    lr, max_norm, regex = 1e-3, 1e-3, 'Hourglass104_0'
    images, anns, mask = synth_batch(2)
    jt, tt = targets_both(anns)
    variables = init_variables(1)
    train_cfg = dict(optimizer='sgd', learning_rate=lr,
                     weight_decay=weight_decay)
    tx = optax.chain(optax.clip_by_global_norm(max_norm),
                     jmake_optimizer(JTrainConfig(**train_cfg)))
    frozen_tree = jax.tree_util.tree_map(
        lambda trainable: not trainable,
        jckpt.freeze_mask(variables['params'], regex))
    tx = optax.chain(optax.masked(optax.set_to_zero(), frozen_tree), tx)
    state, _ = jax.jit(jmake_train_step(JPoseNet(jcfg), tx, JLossConfig(
        stack_weights=(1.0,))))(create_train_state(variables, tx),
                                jnp.asarray(images), jt, jnp.asarray(mask))

    net = port_model(variables, cfg)
    params = dict(net.named_parameters())
    frozen = ckpt.frozen_parameters(net, regex)
    step = TrainStep(net, make_optimizer(TrainConfig(**train_cfg),
                                         net.parameters()),
                     LossConfig(stack_weights=(1.0,)),
                     max_grad_norm=max_norm,
                     frozen=[params[n] for n in frozen])
    step(torch.from_numpy(images), tt, torch.from_numpy(mask))
    grads = [p.grad for n, p in params.items() if n not in frozen]
    assert all(float(params[n].grad.abs().max()) == 0.0 for n in frozen)
    norm = float(torch.linalg.vector_norm(torch.stack(
        [g.norm() for g in grads])))
    assert norm == pytest.approx(max_norm, rel=1e-5)    # the clip bound

    before = flat(variables['params'])
    after = flat(jax.tree_util.tree_map(np.asarray, state.params))
    ours = ckpt.jax_from_state_dict(net.state_dict(), cfg)
    got = flat(ours['params'])
    gmax = max(np.abs(before[k] - after[k]).max() for k in before) / lr
    paths = flax_paths(cfg)
    frozen_keys = {jax.tree_util.keystr(tuple(
        jax.tree_util.DictKey(p) for p in paths[n].split('/')))
        for n in frozen}
    assert frozen_keys and frozen_keys < set(before)
    for k in before:
        np.testing.assert_allclose((before[k] - got[k]) / lr,
                                   (before[k] - after[k]) / lr, rtol=1e-3,
                                   atol=1e-4 * gmax, err_msg=k)
        if k in frozen_keys:
            want = before[k] * np.float32(1 - lr * weight_decay)
            if weight_decay == 0.0:
                np.testing.assert_array_equal(got[k], before[k], err_msg=k)
                np.testing.assert_array_equal(after[k], before[k], err_msg=k)
            else:
                np.testing.assert_allclose(got[k], want, rtol=1e-6,
                                           err_msg=k)
    want = flat(jax.tree_util.tree_map(np.asarray, state.batch_stats))
    start = flat(variables['batch_stats'])
    got = flat(ours['batch_stats'])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    assert any(not np.array_equal(got[k], start[k]) for k in want
               if 'Hourglass104_0' in k)


def records(path):
    import json
    return sorted((r['image_id'], tuple(np.round(r['keypoints'], 2)),
                   round(r['score'], 4)) for r in json.load(open(path)))


def test_cli_freeze_resume_drop_layers_and_evaluate_checkpoint(tmp_path):
    """(e) The CLIs end to end: a warm start from a reference `.pth` with
    `--freeze Hourglass104_0` (the backbone stays bit-equal to the file),
    `--resume` of its checkpoint with `--drop-layers omp_` for one more
    step, then `cli/evaluate.py --checkpoint` of that output gives the
    records `--torch-checkpoint` of the same weights gives."""
    img_dir, ann = make_hard_dataset(str(tmp_path / 'set'), n_images=4,
                                     seed=1, ext='npy')
    base = ['--device', 'cpu', '--debug-tiny-model', '--train-image-dir',
            img_dir, '--train-annotations', ann, '--batch-size', '2',
            '--square-length', '128', '--max-persons', '12',
            '--print-freq', '1', '--freeze', 'Hourglass104_0']
    cfg = train_cli.model_config(train_cli.cli(base), HeadsConfig())
    warm = PoseNet(cfg)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in warm.parameters():
            p.normal_(0.0, 0.05, generator=g)
    pth = str(tmp_path / 'warm.pth')
    torch.save({'model_state_dict': warm.state_dict()}, pth)

    r = train_cli.main(base + ['--torch-checkpoint', pth, '--max-steps', '2',
                               '--checkpoint-dir', str(tmp_path / 'a')])
    assert r['unmatched'] == [] and r['frozen']
    assert all(h['skipped'] == 0.0 for h in r['history'])
    trained = dict(r['model'].named_parameters())
    start = dict(warm.named_parameters())
    assert set(r['frozen']) == {n for n in start if n.startswith('basenet.')}
    for n in start:
        assert torch.equal(trained[n], start[n]) == (n in r['frozen']) or \
            n.startswith(('headnets.0.bghp', 'headnets.0.jitter')), n

    r2 = train_cli.main(base + ['--resume', r['checkpoint'], '--drop-layers',
                                'omp_', '--max-steps', '1',
                                '--checkpoint-dir', str(tmp_path / 'b')])
    saved = torch.load(r2['checkpoint'], weights_only=False)
    assert saved['step'] == 3
    for n in r['frozen']:
        assert torch.equal(saved['model'][n], start[n]), n

    ev = ['--device', 'cpu', '--debug-tiny-model', '--image-dir', img_dir,
          '--annotation-file', ann, '--long-edge', '128', '--batch-size',
          '2', '--person-thre', '0.0', '--thre-hmp', '0.0']
    torch.save({'model_state_dict': saved['model']}, tmp_path / 'out.pth')
    evaluate.main(ev + ['--checkpoint', r2['checkpoint'], '--results-json',
                        str(tmp_path / 'ckpt.json')])
    evaluate.main(ev + ['--torch-checkpoint', str(tmp_path / 'out.pth'),
                        '--results-json', str(tmp_path / 'pth.json')])
    got = records(tmp_path / 'ckpt.json')
    assert got and got == records(tmp_path / 'pth.json')
    with pytest.raises(SystemExit):
        evaluate.cli(ev + ['--checkpoint', 'a', '--torch-checkpoint', 'b'])
