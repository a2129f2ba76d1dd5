"""`cli/train.py --distributed` with two gloo processes on the CPU, as
`tests/test_multihost.py` runs the JAX trainer: the tiny model on the hard
set, two steps on each augmentation route (the host route with two loader
processes per rank), then a resume; rank 0 alone writes the checkpoint,
the ranks end bit-equal, and the weights equal a one-process run of the
same batches at the one-step tolerances. All three runs share one spawn
(`parallel/parity.py::train_cli`)."""
import os

import numpy as np
import pytest
import torch

from offsetguided_tpu_torch.cli import train as train_cli
from offsetguided_tpu_torch.data.synthetic import make_hard_dataset
from offsetguided_tpu_torch.models import checkpoint as ckpt
from offsetguided_tpu_torch.parallel import distributed, parity

LR = 1e-3


@pytest.fixture(scope='module')
def tiny_set(tmp_path_factory):
    return make_hard_dataset(str(tmp_path_factory.mktemp('ddp_train')),
                             n_images=4, seed=1, ext='npy')


def argv(tiny_set, ckpt_dir, *extra):
    """SGD (the step is linear in the gradient) at lr 1e-3, global batch
    2 over 4 images: two steps fill an epoch."""
    img_dir, ann = tiny_set
    return ['--device', 'cpu', '--debug-tiny-model', '--optimizer', 'sgd',
            '--lr', str(LR), '--train-image-dir', img_dir,
            '--train-annotations', ann, '--batch-size', '2',
            '--square-length', '128', '--max-persons', '12',
            '--print-freq', '1', '--checkpoint-dir', str(ckpt_dir), *extra]


ROUTES = {'host': ('--loader-workers', '2'), 'device_aug': ('--device-aug',)}


@pytest.fixture(scope='module')
def runs(tiny_set, tmp_path_factory):
    """Per route, two steps at two ranks; then a one-step resume from the
    host route's checkpoint. Returns the ranks' records of each run and
    the checkpoint directories."""
    root = tmp_path_factory.mktemp('ddp_ckpt')
    dirs = {k: root / k for k in (*ROUTES, 'resume')}
    first = ckpt._ckpt_path(str(dirs['host']), 0)
    plan = [argv(tiny_set, dirs[r], '--max-steps', '2', *ROUTES[r])
            for r in ROUTES]
    plan.append(argv(tiny_set, dirs['resume'], '--max-steps', '1',
                     '--resume', first))
    ranks = distributed.spawn(
        parity.train_cli, 2,
        [(a, distributed.free_port()) for a in plan], 1, timeout=900)
    return {k: [r[i] for r in ranks] for i, k in
            enumerate((*ROUTES, 'resume'))}, dirs, first


@pytest.mark.parametrize('route', sorted(ROUTES))
def test_distributed_cli_trains_on_both_routes(runs, tiny_set, route,
                                               tmp_path):
    """Two steps: finite global losses, no skipped step and the same
    history on both ranks; rank 0 alone reports the checkpoint, which is
    the only file written and holds rank 0's weights; the ranks end
    bit-equal; and the weights equal a one-process run of the same two
    global batches (gradients within rtol 1e-3 and 1e-4 of the largest,
    BN statistics within 1e-5)."""
    recs, dirs, _ = runs
    r0, r1 = recs[route]
    assert (r0['rank'], r1['rank'], r0['world']) == (0, 1, 2)
    assert r0['steps'] == r1['steps'] == 2
    for h0, h1 in zip(r0['history'], r1['history']):
        assert h0['skipped'] == h1['skipped'] == 0.0
        assert np.isfinite(h0['total']) and h0['total'] == h1['total']
    assert r1['checkpoint'] is None
    assert os.listdir(dirs[route]) == [os.path.basename(r0['checkpoint'])]
    saved = torch.load(r0['checkpoint'], weights_only=False)
    assert saved['step'] == 2
    for k, v in saved['model'].items():
        assert np.array_equal(v.numpy(), r0['state'][k]), k
    assert r0['digest'] == r1['digest']

    serial = () if route == 'host' else ROUTES[route]    # one loader thread
    one = train_cli.main(argv(tiny_set, tmp_path, '--max-steps', '2',
                              *serial))
    for h, h0 in zip(one['history'], r0['history']):
        np.testing.assert_allclose(h0['total'], h['total'], rtol=1e-4)
    want = {k: v.numpy() for k, v in one['model'].state_dict().items()}
    start = ckpt_init_state(tiny_set)
    gmax = max(np.abs(start[k] - want[k]).max() for k in start) / LR
    for k in start:
        np.testing.assert_allclose((start[k] - r0['state'][k]) / LR,
                                   (start[k] - want[k]) / LR, rtol=1e-3,
                                   atol=1e-4 * gmax, err_msg=k)
    for k in want:
        if 'running' in k:
            np.testing.assert_allclose(r0['state'][k], want[k], rtol=0,
                                       atol=1e-5, err_msg=k)


def ckpt_init_state(tiny_set):
    """The trainer's initial weights (`init_reference_` from seed 0)."""
    from offsetguided_tpu_torch.config.defaults import HeadsConfig
    from offsetguided_tpu_torch.models import PoseNet
    from offsetguided_tpu_torch.models.network import init_reference_
    cfg = train_cli.model_config(train_cli.cli(argv(tiny_set, 'x')),
                                 HeadsConfig())
    net = init_reference_(PoseNet(cfg), torch.Generator().manual_seed(0))
    return {k: v.numpy() for k, v in net.state_dict().items()
            if k.endswith(('weight', 'bias'))}


def test_distributed_cli_resumes(runs):
    """`--resume` on every rank from rank 0's checkpoint goes on from its
    step: one more step, saved by rank 0 as step 3, ranks bit-equal."""
    recs, dirs, first = runs
    r0, r1 = recs['resume']
    assert r0['steps'] == r1['steps'] == 1 and r1['checkpoint'] is None
    assert torch.load(r0['checkpoint'], weights_only=False)['step'] == 3
    assert r0['digest'] == r1['digest']
    assert os.listdir(dirs['resume']) == [os.path.basename(r0['checkpoint'])]
