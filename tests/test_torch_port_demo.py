"""The port's image demo (`cli/demo.py`) against the JAX package's on the
same tiny weights: seeded JAX variables written by the JAX package's
`save_torch_checkpoint` reach both demos as `--torch-checkpoint`, with
`ModelConfig` narrowed in each package (as tests/test_integration.py
does), on two 96 x 128 PNGs (long edge 128: no resize) with flip test, heatmaps, limb offsets, all limbs
and an annotation file. Each image's inverse-transformed poses agree
within 1e-3 px (fp32 forward and decode on the CPU, summed in other
orders), the losses within 1e-4 relative, and the same PNG names are
written; the port's PNGs decode through its codec. One JAX compile."""
import json
import os
import sys

import matplotlib
import numpy as np
import pytest

from offsetguided_tpu.config import defaults as JD
from offsetguided_tpu.models import checkpoint as jckpt
from offsetguided_tpu_torch.cli import demo
from offsetguided_tpu_torch.config import defaults as TD
from offsetguided_tpu_torch.data import codec

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_serve import (  # noqa: E402
    jit_posenet_init, tamed_variables)

JModelConfig, TModelConfig = JD.ModelConfig, TD.ModelConfig
TINY = dict(n_stacks=1, hg_order=2, dims=(8, 8, 12), modules=(1, 1, 1),
            cnv_dim=8, compute_dtype='float32')
H, W = 96, 128


def person(x0, y0, rng):
    """A 17-keypoint COCO annotation in a 40 x 60 box at (x0, y0)."""
    kps = np.zeros((17, 3))
    kps[:, 0] = x0 + rng.rand(17) * 40
    kps[:, 1] = y0 + rng.rand(17) * 60
    kps[:, 2] = 2
    kps[rng.rand(17) < 0.2, 2] = 0
    return {'category_id': 1, 'iscrowd': 0,
            'num_keypoints': int((kps[:, 2] > 0).sum()),
            'keypoints': kps.ravel().round(2).tolist(),
            'bbox': [x0, y0, 40, 60], 'area': 2400.0}


@pytest.fixture(scope='module')
def inputs(tmp_path_factory):
    """Two noise PNGs, their annotations (two persons each) and the
    weights as a reference `.pth`."""
    root = tmp_path_factory.mktemp('demo')
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i in range(2):
        path = str(root / f'img{i}.png')
        codec.imwrite(path, rng.randint(0, 256, (H, W, 3), dtype=np.uint8))
        images.append({'id': i + 1, 'file_name': f'img{i}.png',
                       'height': H, 'width': W})
        for x0 in (10, 70):
            anns.append(dict(person(x0, 20, rng), id=len(anns) + 1,
                             image_id=i + 1))
    ann = str(root / 'ann.json')
    with open(ann, 'w') as f:
        json.dump({'images': images, 'annotations': anns,
                   'categories': [{'id': 1, 'name': 'person'}]}, f)
    pth = str(root / 'tiny.pth')
    jcfg = JModelConfig(**TINY)
    jckpt.save_torch_checkpoint(pth, tamed_variables(jcfg), jcfg)
    paths = [str(root / im['file_name']) for im in images]
    return paths, ann, pth, root


def flags(inputs, out_dir):
    paths, ann, pth, _ = inputs
    return paths + ['--torch-checkpoint', pth, '--long-edge', '128',
                    '--flip-test', '--show-heatmaps', '--show-limb-offsets',
                    '0', '--show-all-limbs', '--annotation-file', ann,
                    '--output-dir', str(out_dir)]


@pytest.fixture(scope='module')
def runs(inputs):
    """Both demos once: ({'poses', 'losses', 'files'} per image)."""
    mp = pytest.MonkeyPatch()
    root = inputs[3]
    try:
        mp.setattr(TD, 'ModelConfig', lambda **kw: TModelConfig(**TINY, **kw))
        ours = demo.main(flags(inputs, root / 'port') + ['--device', 'cpu'])

        matplotlib.use('Agg')
        from offsetguided_tpu.cli import demo as jdemo
        from offsetguided_tpu.ops import losses as jlosses
        from offsetguided_tpu.visualization import KeypointPainter
        mp.setattr(JD, 'ModelConfig', lambda **kw: JModelConfig(**TINY, **kw))
        jit_posenet_init(mp)
        poses, losses = [], []
        paint = KeypointPainter.keypoints
        mp.setattr(KeypointPainter, 'keypoints',
                   lambda self, ax, p, **kw: (poses.append(np.asarray(p)),
                                              paint(self, ax, p, **kw)))
        compute = jlosses.compute_losses
        mp.setattr(jlosses, 'compute_losses',
                   lambda *a, **kw: losses.append(compute(*a, **kw))
                   or losses[-1])
        mp.setattr(sys, 'argv', ['demo'] + flags(inputs, root / 'jax'))
        jdemo.main()
        theirs = [{'poses': p, 'losses': {k: float(v) for k, v in l.items()},
                   'files': sorted(f for f in os.listdir(root / 'jax')
                                   if f.startswith(f'img{i}.'))}
                  for i, (p, l) in enumerate(zip(poses, losses))]
    finally:
        mp.undo()
    return ours, theirs


def test_demo_poses_match_jax(runs):
    ours, theirs = runs
    assert len(ours) == len(theirs) == 2
    for o, t in zip(ours, theirs):
        assert o['poses'].shape == t['poses'].shape and len(o['poses'])
        np.testing.assert_allclose(o['poses'], t['poses'], rtol=0, atol=1e-3)


def test_demo_losses_match_jax(runs):
    for o, t in zip(*runs):
        assert o['losses'].keys() == t['losses'].keys()
        for k, v in t['losses'].items():
            np.testing.assert_allclose(o['losses'][k], v, rtol=1e-4,
                                       err_msg=k)


def test_demo_writes_the_same_pngs(runs):
    for i, (o, t) in enumerate(zip(*runs)):
        names = sorted(os.path.basename(f) for f in o['files'])
        assert names == t['files'] == sorted(
            f'img{i}.{kind}.png' for kind in ('poses', 'hmp', 'omp', 'limbs'))


def test_demo_pngs_decode(runs):
    """.poses.png at the image's size, the others at the network input's."""
    for o in runs[0]:
        for f in o['files']:
            img = codec.imread(f)
            want = (H, W) if f.endswith('.poses.png') else (128, 128)
            assert img is not None and img.shape == want + (3,), f


def test_demo_cli_flags_match_jax():
    """Every JAX demo flag, and `--device`."""
    from offsetguided_tpu.cli import demo as jdemo
    mp = pytest.MonkeyPatch()
    mp.setattr(sys, 'argv', ['demo', 'a.png'])
    try:
        theirs = vars(jdemo.cli())
    finally:
        mp.undo()
    ours = vars(demo.cli(['a.png']))
    assert ours.pop('device') is None
    assert ours == theirs
