"""The port's self-check (`cli/selfcheck.py`) against the JAX package's, on
the CPU: the dataset's annotations, a few-step run on both augmentation
routes, and the trained-weights record-identity gate: the self-check
model trained by the port, handed to JAX, gives identical per-image COCO
record sets through both packages' `run_images` at fp32 in five decode
modes."""
import json
import pathlib

import cv2
import numpy as np
import pytest

from offsetguided_tpu.cli import selfcheck as jselfcheck
from offsetguided_tpu.config.defaults import DecoderConfig as JDecoderConfig
from offsetguided_tpu.config.defaults import EvalConfig as JEvalConfig
from offsetguided_tpu.config.defaults import HeadsConfig as JHeadsConfig
from offsetguided_tpu.config.defaults import ModelConfig as JModelConfig
from offsetguided_tpu.data.coco import CocoJson as JCocoJson
from offsetguided_tpu.decoder import PostProcessor as JPostProcessor
from offsetguided_tpu.eval import harness as jharness
from offsetguided_tpu.models import PoseNet as JPoseNet
from offsetguided_tpu_torch.cli import selfcheck
from offsetguided_tpu_torch.config.defaults import DecoderConfig, EvalConfig
from offsetguided_tpu_torch.data.coco import CocoJson
from offsetguided_tpu_torch.decoder import PostProcessor
from offsetguided_tpu_torch.eval import harness
from offsetguided_tpu_torch.models.checkpoint import jax_from_state_dict

# Fewest steps whose model gives every self-check image a pose and an AP
# above 0 (measured on the CPU, seed 0: AP 0 after 10, 20 and 30 steps;
# 0.017 after 40).
GATE_STEPS = 40
# decode modes of the gate: EvalConfig fields, and upsampled_decode
MODES = {
    'long_edge': dict(),
    'long_edge_flip': dict(flip_test=True),
    'fixed_height': dict(fixed_height=True),
    'fixed_height_flip': dict(fixed_height=True, flip_test=True),
    'lowres_decode': dict(upsampled_decode=False),
}


def test_make_dataset_matches_jax(tmp_path):
    """Annotations identical to the JAX package's, draw for draw; the
    images (numpy drawing and the codec's JPEG round trip, `.npy`)
    identical to the JAX package's JPEGs as its reader gives them."""
    jdir, jann = jselfcheck.make_dataset(tmp_path / 'jax')
    img_dir, ann = selfcheck.make_dataset(tmp_path / 'port')
    ref, ours = (json.loads(pathlib.Path(f).read_text())
                 for f in (jann, ann))
    assert ours['annotations'] == ref['annotations']
    assert ours['categories'] == ref['categories']
    for a, b in zip(ref['images'], ours['images']):
        assert b['file_name'] == a['file_name'].replace('.jpg', '.npy')
        assert {k: v for k, v in a.items() if k != 'file_name'} == \
            {k: v for k, v in b.items() if k != 'file_name'}
        img = np.load(pathlib.Path(img_dir) / b['file_name'])
        assert img.shape == (256, 320, 3) and img.dtype == np.uint8
        ref = cv2.cvtColor(cv2.imread(str(pathlib.Path(jdir)
                                          / a['file_name'])),
                           cv2.COLOR_BGR2RGB)
        assert np.array_equal(img, ref)


@pytest.mark.parametrize('route', ['host', 'device_aug'])
def test_selfcheck_runs_on_cpu(tmp_path, route):
    """Three steps on each route: finite statistics and records, and the
    exit rule of --min-ap (no AP reaches 2)."""
    argv = ['--device', 'cpu', '--steps', '3', '--min-ap', '2',
            '--work-dir', str(tmp_path)]
    r = selfcheck.main(argv + (['--device-aug'] if route == 'device_aug'
                               else []))
    assert r['steps'] == 3 and not r['passed'] and r['device'] == 'cpu'
    assert set(r['stats']) >= {'AP', 'AP50', 'AP75'}
    assert all(np.isfinite(v) for v in r['stats'].values())
    assert r['results'] and all(np.isfinite(x['score'])
                                for x in r['results'])


def record_sets(records):
    """Per image, the set of (keypoints to 2 decimals, score to 4)."""
    out = {}
    for r in records:
        out.setdefault(r['image_id'], set()).add(
            (tuple(np.round(r['keypoints'], 2)), round(r['score'], 4)))
    return out


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """The self-check model trained by the port on the CPU for GATE_STEPS,
    its weights as a JAX tree, and the self-check images as .png (read by
    both packages)."""
    root = tmp_path_factory.mktemp('gate')
    r = selfcheck.main(['--device', 'cpu', '--steps', str(GATE_STEPS),
                        '--min-ap', '0', '--work-dir', str(root)])
    assert r['stats']['AP'] > 0      # real peaks: the gate is not vacuous
    ann = json.loads(pathlib.Path(r['annotations']).read_text())
    png = root / 'png'
    png.mkdir()
    for im in ann['images']:
        img = np.load(pathlib.Path(r['image_dir']) / im['file_name'])
        im['file_name'] = im['file_name'].replace('.npy', '.png')
        cv2.imwrite(str(png / im['file_name']),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    ann_file = root / 'png.json'
    ann_file.write_text(json.dumps(ann))
    variables = jax_from_state_dict(r['state_dict'], r['model_cfg'])
    jcfg = JModelConfig(n_stacks=1, hg_order=3, dims=(48, 48, 64, 96),
                        modules=(1, 1, 1, 1), cnv_dim=48,
                        compute_dtype='float32', heads=JHeadsConfig())
    return r, JPoseNet(jcfg), variables, str(png), str(ann_file)


@pytest.mark.slow
@pytest.mark.parametrize('mode', sorted(MODES))
def test_trained_records_match_jax(trained, mode):
    """Trained weights, fp32, both packages' `run_images`: identical
    per-image record sets. Not vacuous: every image yields a pose, and the
    model's AP on the self-check annotations (its own long-edge
    evaluation) is above 0. (Marked slow: the JAX side compiles one
    forward + decode program per mode, about 20 s each on the CPU, past
    the one-process budget.)"""
    r, jmodel, variables, png, ann_file = trained
    kw = dict(MODES[mode])
    upsampled = kw.pop('upsampled_decode', True)
    ecfg = dict(long_edge=128, flip_test=False, batch_size=2, max_stride=32,
                width_bucket=64)
    ecfg.update(kw)
    dec = dict(topk=8, thre_hmp=0.05, dist_max=25.0, use_scale=True,
               person_thre=0.03, max_poses=8, upsampled_decode=upsampled)
    jcoco, coco = JCocoJson(ann_file), CocoJson(ann_file)
    ref = jharness.run_images(jmodel, variables,
                              JPostProcessor(cfg=JDecoderConfig(**dec)),
                              jcoco, png, JEvalConfig(**ecfg))
    ours = harness.run_images(r['model'], PostProcessor(
        cfg=DecoderConfig(**dec)), coco, png, EvalConfig(**ecfg))
    a, b = record_sets(ref), record_sets(ours)
    assert sorted(a) == sorted(b) == sorted(coco.image_ids())
    assert all(len(v) >= 1 for v in b.values())
    assert b == a
