"""The port's 4-stage backbone and 3x3 tower heads against the JAX package on
the CPU, with weights carried across by `state_dict_from_jax` /
`jax_from_state_dict`: the parameter tree and count, the eval forward (BN
folded and not), the train-mode forward with its BatchNorm statistics and
gradients, remat, the weight round trip, the port's checkpoints, and one
`cli.train --basenet hourglass4stage` step's losses.

The 4-stage net has fixed widths (256 features, +128 channels a scale), so
it runs at full width here, with one or two stacks. The eval comparisons
take `random_posenet`'s weights (He-scaled, BatchNorm calibrated on a
seeded batch of 32 noise images at 64^2: uncalibrated, a deep random
hourglass grows its activations to 1e11; calibrated on 8, the 1x1 level
at the bottom of the hourglass holds too few values for stable
statistics). The train-mode comparison starts from the trainer's initial
weights at 128^2, as tests/test_torch_port_train.py's one-step test does:
with random calibrated weights, train-mode BatchNorm's fast variance
carries fp32 rounding through the net's ~60 normalized layers, and the
head outputs (magnitude ~3) then differ from JAX's by up to 2.5e-4
beyond the tolerance's relative part, past its absolute 2e-4, even at
256^2; at 64^2 the bottom level normalizes two values per channel."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offsetguided_tpu.config import COCO_PERSON_SIGMAS, COCO_PERSON_SKELETON
from offsetguided_tpu.config.defaults import EncoderConfig as JEncoderConfig
from offsetguided_tpu.config.defaults import HeadsConfig as JHeadsConfig
from offsetguided_tpu.config.defaults import LossConfig as JLossConfig
from offsetguided_tpu.config.defaults import ModelConfig as JModelConfig
from offsetguided_tpu.config.defaults import TrainConfig as JTrainConfig
from offsetguided_tpu.models import PoseNet as JPoseNet
from offsetguided_tpu.ops.encoder import downscale_mask as jdownscale_mask
from offsetguided_tpu.ops.encoder import encode_targets as jencode_targets
from offsetguided_tpu.parallel import create_train_state
from offsetguided_tpu.parallel import make_optimizer as jmake_optimizer
from offsetguided_tpu.parallel import make_train_step as jmake_train_step
from offsetguided_tpu_torch.cli import train as train_cli
from offsetguided_tpu_torch.config.defaults import ModelConfig, TrainConfig
from offsetguided_tpu_torch.data.synthetic import make_hard_dataset
from offsetguided_tpu_torch.models import (PoseNet, count_params,
                                           random_posenet,
                                           state_dict_from_jax)
from offsetguided_tpu_torch.models import checkpoint as ckpt
from offsetguided_tpu_torch.models.layers import BatchNorm2d
from offsetguided_tpu_torch.models.network import init_he_, init_reference_
from offsetguided_tpu_torch.ops.image import normalize_images
from offsetguided_tpu_torch.parallel.train_step import make_optimizer
from test_torch_port_model import tiny

# the suite's worker processes share the host's cores
torch.set_num_threads(2)

# the fp32 forward tolerance of tests/test_converter_numeric.py
RTOL, ATOL = 2e-3, 2e-4
SIZE = 64
FOUR = dict(basenet='hourglass4stage', compute_dtype='float32')


def configs(n_stacks):
    return (JModelConfig(n_stacks=n_stacks, **FOUR),
            ModelConfig(n_stacks=n_stacks, **FOUR))


def images(seed, n=2, size=SIZE):
    """Normalized float images of uint8 noise, as the model sees them."""
    x = np.random.RandomState(seed).randint(0, 256, (n, size, size, 3),
                                            dtype=np.uint8)
    return normalize_images(torch.from_numpy(x))


def flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def heads_close(ours, ref, n_stacks, what):
    for key in ('hmp', 'bg', 'jomp', 'omp', 'scmp'):
        for s in range(n_stacks):
            np.testing.assert_allclose(
                ours[key][s].detach().numpy(), np.asarray(ref[key][s]),
                rtol=RTOL, atol=ATOL, err_msg=f'{what} {key} {s}')


@pytest.fixture(scope='module')
def one_stack():
    """The 1-stack net with calibrated random weights, and its JAX tree."""
    _, cfg = configs(1)
    net = random_posenet(cfg, 0, device='cpu', calib_size=SIZE,
                         calib_batch=32)
    return net, ckpt.jax_from_state_dict(net.state_dict(), cfg)


def test_parameter_tree_and_count_match_jax():
    """At the trainer's 2 stacks: the port's tree (through
    `jax_from_state_dict`) is the JAX model's own, leaf for leaf and shape
    for shape; 32,445,174 parameters on both sides."""
    jcfg, cfg = configs(2)
    ref = jax.eval_shape(functools.partial(JPoseNet(jcfg).init, train=False),
                         jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    net = PoseNet(cfg)
    ours = ckpt.jax_from_state_dict(net.state_dict(), cfg)
    assert jax.tree_util.tree_structure(ours) == \
        jax.tree_util.tree_structure(ref)
    assert {k: v.shape for k, v in flat(ours).items()} == {
        jax.tree_util.keystr(k): v.shape
        for k, v in jax.tree_util.tree_leaves_with_path(ref)}
    n_ref = sum(int(np.prod(x.shape))
                for x in jax.tree_util.tree_leaves(ref['params']))
    assert count_params(net) == n_ref == 32_445_174
    assert len(jax.tree_util.tree_leaves(ref['params'])) == 367


def test_flax_torch_flax_round_trip_is_bit_equal(tmp_path):
    """A JAX tree of seeded values -> the port -> back gives the same
    arrays bit for bit; and the port's own checkpoints save and restore a
    4-stage model and its Adam state exactly."""
    _, cfg = configs(2)
    net = init_he_(PoseNet(cfg), 3)
    tree = ckpt.jax_from_state_dict(net.state_dict(), cfg)
    back = ckpt.jax_from_state_dict(state_dict_from_jax(tree, cfg), cfg)
    want, got = flat(tree), flat(back)
    assert want.keys() == got.keys() and len(want) == 367 + 226
    for k in want:
        assert want[k].dtype == got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    opt = make_optimizer(TrainConfig(), net.parameters())
    net(images(0)).get('hmp')[0].sum().backward()
    opt.step()
    path = ckpt.save_checkpoint(str(tmp_path), net, opt, step=7, epoch=2)
    net2 = PoseNet(cfg)
    opt2 = make_optimizer(TrainConfig(), net2.parameters())
    assert ckpt.load_checkpoint(path, net2, opt2)[:2] == (7, 2)
    for k, v in net.state_dict().items():
        assert torch.equal(net2.state_dict()[k], v), k
    st, st2 = opt.state_dict()['state'], opt2.state_dict()['state']
    assert st.keys() == st2.keys() and st
    assert all(torch.equal(st[i]['exp_avg'], st2[i]['exp_avg']) for i in st)


def test_eval_forward_matches_jax(one_stack):
    """The eval forward at fp32 (JAX folds each BatchNorm into its conv):
    the port unfolded and folded (`prepare_inference`) within the fp32
    forward tolerance."""
    net, variables = one_stack
    jcfg, cfg = configs(1)
    x = images(1)
    ref = jax.jit(functools.partial(JPoseNet(jcfg).apply, train=False))(
        variables, jnp.asarray(x.numpy()))
    net.eval()
    with torch.no_grad():
        heads_close(net(x), ref, 1, 'unfolded')
    folded = PoseNet(cfg)
    folded.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    folded.prepare_inference()
    with torch.no_grad():
        heads_close(folded(x), ref, 1, 'folded')


def test_folded_equals_unfolded_and_no_batchnorm_left(one_stack):
    """`prepare_inference` folds every (conv, BatchNorm) pair of the 4-stage
    net, the bottlenecks' `conv3`/`bn3` and projected skips included: no
    BatchNorm2d is left, and at fp32 the folded forward equals the
    unfolded one within 1e-4 relative (the fold only reassociates)."""
    net, variables = one_stack
    _, cfg = configs(1)
    folded = PoseNet(cfg)
    folded.load_state_dict(net.state_dict(), strict=True)
    n_bn = sum(isinstance(m, BatchNorm2d) for m in folded.modules())
    assert n_bn == 63
    folded.prepare_inference()
    assert not any(isinstance(m, torch.nn.BatchNorm2d)
                   for m in folded.modules())
    x = images(2)
    net.eval()
    with torch.no_grad():
        a, b = net(x), folded(x)
    for key in ('hmp', 'omp', 'scmp'):
        scale = float(a[key][0].abs().max())
        np.testing.assert_allclose(b[key][0].numpy(), a[key][0].numpy(),
                                   rtol=1e-4, atol=1e-4 * scale, err_msg=key)


def test_train_forward_statistics_and_gradients_match_jax():
    """Train mode from the trainer's initial weights (`init_reference_`)
    at 128^2: head outputs within the forward tolerance and the running
    statistics after the batch within 1e-5 of flax's (the tolerances of
    tests/test_torch_port_train.py).

    Gradients of the sum of squared head outputs, held against the exact
    gradient (the port's in fp64): through the net's ~60 train-mode
    BatchNorms an fp32 backward is far from it, the port's by a median
    1.9 % of a leaf's largest gradient, JAX's by 6.6 % and up to 63 % (its
    fast variance is differentiated term by term, a difference of two
    large terms; the port's backward is the closed form). So: the heads'
    and the SE layer's gradients equal JAX's within rtol 1e-3 and 1e-4 of
    the largest gradient; every leaf of the port is at least as close to
    the exact gradient as JAX's (up to that 1e-4); and every leaf of JAX's
    points the exact gradient's way (cosine >= 0.99), so the exact
    gradient is of JAX's function."""
    jcfg, cfg = configs(1)
    net = init_reference_(PoseNet(cfg), torch.Generator().manual_seed(0))
    variables = ckpt.jax_from_state_dict(net.state_dict(), cfg)
    x = images(3, size=2 * SIZE)

    def loss(params):
        out, mut = JPoseNet(jcfg).apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            jnp.asarray(x.numpy()), train=True, mutable=['batch_stats'])
        total = sum(jnp.sum(m ** 2) for maps in out.values()
                    for m in maps if m is not None)
        return total, (out, mut['batch_stats'])

    (jl, (ref, stats)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables['params'])
    port = PoseNet(cfg)
    port.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    port.train()
    out = port(x)
    heads_close(out, ref, 1, 'train')
    tl = sum((m ** 2).sum() for maps in out.values() for m in maps
             if m is not None)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    tl.backward()

    got = ckpt.jax_from_state_dict(port.state_dict(), cfg)
    want = flat(stats)
    g = flat(got['batch_stats'])
    moved = flat(variables['batch_stats'])
    assert g.keys() == want.keys() and len(want) == 63 * 2
    for k in want:
        np.testing.assert_allclose(g[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    assert max(np.abs(want[k] - moved[k]).max() for k in want) > 1e-2

    fp64 = PoseNet(dataclasses.replace(
        cfg, compute_dtype='float64')).double()
    fp64.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    fp64.train()
    sum((m ** 2).sum() for maps in fp64(x.double()).values() for m in maps
        if m is not None).backward()

    def grad_tree(net):
        sd = {k: p.grad for k, p in net.named_parameters()}
        sd.update(dict(net.named_buffers()))
        return flat(ckpt.jax_from_state_dict(sd, cfg)['params'])

    ours, exact, theirs = grad_tree(port), grad_tree(fp64), flat(grads)
    gmax = max(np.abs(v).max() for v in theirs.values())
    for k in theirs:
        if 'PoseHeads' in k or 'SELayer' in k:
            np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-3,
                                       atol=1e-4 * gmax, err_msg=k)
        e_port = np.abs(ours[k] - exact[k]).max()
        e_jax = np.abs(theirs[k] - exact[k]).max()
        assert e_port <= e_jax + 1e-4 * gmax, (k, e_port, e_jax)
        a, b = theirs[k].ravel().astype(np.float64), exact[k].ravel()
        assert a @ b >= 0.99 * np.linalg.norm(a) * np.linalg.norm(b), k


def test_remat_gives_the_same_gradients():
    """`remat` recomputes each 4-stage hourglass in the backward (2 stacks,
    as tests/test_model.py runs it): the same loss, gradients and running
    statistics, each batch counted once."""
    _, cfg = configs(2)
    x = images(4)
    out = []
    for remat in (False, True):
        net = random_posenet(dataclasses.replace(cfg, remat=remat), 0,
                             device='cpu', calib_size=SIZE, calib_batch=8)
        net.train()
        o = net(x)
        loss = sum((m ** 2).sum() for maps in o.values() for m in maps
                   if m is not None)
        loss.backward()
        out.append((loss.item(), {k: p.grad.clone()
                                  for k, p in net.named_parameters()},
                    {k: b.clone() for k, b in net.named_buffers()}))
    (l0, g0, b0), (l1, g1, b1) = out
    assert l1 == pytest.approx(l0, rel=1e-6)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-5, atol=1e-7,
                                   msg=k)
    for k in b0:
        torch.testing.assert_close(b1[k], b0[k], msg=k)


def test_tower_heads_forward_matches_jax():
    """`HeadsConfig(tower=True, tower_dim=16)` on a narrow Hourglass-104:
    the port's tree is the JAX model's (3x3 conv + ReLU + 1x1 per head),
    the weights go there and back bit for bit, and every head and stack
    is within the fp32 forward tolerance."""
    jcfg, cfg = tiny(tower=True, tower_dim=16)
    net = init_he_(PoseNet(cfg), 5)
    assert net.headnets[0].hp_convs[1][0].kernel_size == (3, 3)
    variables = ckpt.jax_from_state_dict(net.state_dict(), cfg)
    ref = jax.eval_shape(functools.partial(JPoseNet(jcfg).init, train=False),
                         jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    assert {k: v.shape for k, v in flat(variables).items()} == {
        jax.tree_util.keystr(k): v.shape
        for k, v in jax.tree_util.tree_leaves_with_path(ref)}
    back = state_dict_from_jax(variables, cfg)
    for k, v in net.state_dict().items():
        assert torch.equal(back[k], v), k
    x = np.random.RandomState(6).rand(2, SIZE, SIZE, 3).astype(np.float32)
    out = jax.jit(functools.partial(JPoseNet(jcfg).apply, train=False))(
        variables, jnp.asarray(x))
    net.prepare_inference()
    with torch.no_grad():
        heads_close(net(torch.from_numpy(x)), out, 2, 'tower')


def test_cli_train_4stage_step_matches_jax(tmp_path, monkeypatch):
    """One `cli.train --basenet hourglass4stage --n-stacks 1` step on the
    host route (fp32: `--debug-tiny-model` leaves the 4-stage widths
    alone): its losses equal the JAX train step's on the same batch and
    initial weights within 1e-4 relative, and a checkpoint is written."""
    img_dir, ann = make_hard_dataset(str(tmp_path / 'data'), n_images=2,
                                     seed=1, ext='npy')
    seen = []
    feed = train_cli.device_batch

    def spy(batch, *a, **kw):
        seen.append({k: np.array(v) for k, v in batch.items()})
        return feed(batch, *a, **kw)

    monkeypatch.setattr(train_cli, 'device_batch', spy)
    argv = ['--device', 'cpu', '--debug-tiny-model', '--basenet',
            'hourglass4stage', '--n-stacks', '1', '--train-image-dir',
            img_dir, '--train-annotations', ann, '--batch-size', '2',
            '--square-length', str(SIZE), '--max-persons', '12',
            '--print-freq', '1', '--max-steps', '1', '--checkpoint-dir',
            str(tmp_path / 'ckpt')]
    r = train_cli.main(argv)
    assert r['steps'] == 1 and r['model_cfg'].basenet == 'hourglass4stage'
    h = r['history'][0]
    assert h['skipped'] == 0.0 and r['checkpoint']

    jcfg = JModelConfig(n_stacks=1, heads=JHeadsConfig(), **FOUR)
    cfg = r['model_cfg']
    init = init_reference_(PoseNet(cfg), torch.Generator().manual_seed(0))
    variables = ckpt.jax_from_state_dict(init.state_dict(), cfg)
    batch = seen[0]
    targets = jencode_targets(
        jnp.asarray(batch['anns']), np.asarray(COCO_PERSON_SIGMAS),
        COCO_PERSON_SKELETON, SIZE // 4, SIZE // 4,
        JEncoderConfig(max_persons=12))
    enc = JEncoderConfig(max_persons=12)
    tx = jmake_optimizer(JTrainConfig(optimizer='sgd'))
    _, jm = jax.jit(jmake_train_step(JPoseNet(jcfg), tx, JLossConfig(
        stack_weights=(1.0,))))(create_train_state(variables, tx),
                                jnp.asarray(batch['image']), targets,
                                jdownscale_mask(jnp.asarray(
                                    batch['mask_miss']), enc))
    for k in ('total', 'hmp', 'omp', 'scmp'):
        np.testing.assert_allclose(h[k], float(jm[k]), rtol=1e-4, err_msg=k)
    assert float(jm['hmp']) > 0
