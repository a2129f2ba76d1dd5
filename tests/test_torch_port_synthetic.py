"""The port's synthetic sets against the JAX package's generator: the crowd
set's annotations (`make_crowd_dataset`) written to the same JSON bytes,
both generator command lines (hard set and `--crowd`) giving the same
files and printing the same two lines, and the crowd oracle at capacity 16
with `max_poses` 40 (the port's output has 40 rows, JAX's XLA grouping
16) through the port's `cli.simulate` on the CPU equal to the JAX
package's oracle: the same AP and the same records."""
import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offsetguided_tpu.config.defaults import DecoderConfig as JDecoderConfig
from offsetguided_tpu.config.defaults import EncoderConfig as JEncoderConfig
from offsetguided_tpu.config.defaults import SkeletonConfig as JSkeletonConfig
from offsetguided_tpu.data import synthetic as jsynthetic
from offsetguided_tpu.data import transforms as JT
from offsetguided_tpu.data.coco import CocoJson as JCocoJson
from offsetguided_tpu.decoder import PostProcessor as JPostProcessor
from offsetguided_tpu.eval import cocoeval as jcocoeval
from offsetguided_tpu.eval import harness as jharness
from offsetguided_tpu.ops.encoder import encode_targets as jencode_targets
from offsetguided_tpu_torch.cli import simulate
from offsetguided_tpu_torch.data import codec, synthetic
from offsetguided_tpu_torch.eval import harness

# the suite's worker processes share the host's cores
torch.set_num_threads(2)

# the recorded crowd sweep's command (BENCHMARKS.md, round 5): topk 80,
# max_persons 70, simulate's other defaults
CROWD_ORACLE = dict(topk=80, thre_hmp=0.1, dist_max=40.0, max_persons=70)


def read(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize('seed', [0, 1])
def test_crowd_annotations_equal_jax(seed, tmp_path):
    """Two crowd scenes: the same annotation dict and the same file bytes
    as the JAX generator's, and the port's images (painted JPEGs through
    the codec, unpainted .npy) at the scenes' size."""
    _, jann = jsynthetic.make_crowd_dataset(str(tmp_path / 'jax'),
                                            n_images=2, seed=seed,
                                            paint=False)
    ours = synthetic.crowd_annotations(2, seed=seed)
    assert ours == json.loads(read(jann))
    img_dir, ann = synthetic.make_crowd_dataset(str(tmp_path / 'port'),
                                                n_images=2, seed=seed)
    assert read(ann) == read(jann)
    assert 50 * 2 * 0.8 < len(ours['annotations']) <= 70 * 2
    for info in ours['images']:
        img = codec.imread(os.path.join(img_dir, info['file_name']))
        assert img.shape == (640, 640, 3)
    npy_dir, _ = synthetic.make_crowd_dataset(str(tmp_path / 'npy'),
                                              n_images=1, seed=seed,
                                              ext='npy')
    assert np.load(os.path.join(npy_dir, '000001.npy')).shape == (640, 640, 3)


def run_cli(module, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, 'argv', [module] + argv)
    runpy.run_module(module, run_name='__main__')
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize('crowd', [False, True])
def test_generator_cli_equals_jax(crowd, tmp_path, capsys, monkeypatch):
    """`python -m ...data.synthetic OUT --n-images 2 --seed 3 [--crowd
    50,70]` of both packages: each prints its image directory and
    annotation file, and the annotation files are byte-equal."""
    flags = ['--n-images', '2', '--seed', '3']
    if crowd:
        flags += ['--crowd', '50,70']
    outs = {}
    for name, module in (('jax', 'offsetguided_tpu.data.synthetic'),
                         ('port', 'offsetguided_tpu_torch.data.synthetic')):
        out = str(tmp_path / name)
        lines = run_cli(module, [out] + flags, capsys, monkeypatch)
        assert lines == [os.path.join(out, 'images'),
                         os.path.join(out, 'annotations.json')]
        assert sorted(os.listdir(lines[0])) == ['000001.jpg', '000002.jpg']
        outs[name] = read(lines[1])
    assert outs['port'] == outs['jax']
    n = len(json.loads(outs['port'])['annotations'])
    assert (n > 80) == crowd


def jax_crowd_oracle(ann_file, capacity, max_poses):
    """The JAX package's `cli/simulate.py` loop at the crowd sweep's
    settings: its stats and its records."""
    skeleton = JSkeletonConfig()
    enc_cfg = JEncoderConfig(max_persons=CROWD_ORACLE['max_persons'])
    pp = JPostProcessor(skeleton=skeleton, cfg=JDecoderConfig(
        topk=CROWD_ORACLE['topk'], thre_hmp=CROWD_ORACLE['thre_hmp'],
        dist_max=CROWD_ORACLE['dist_max'], use_scale=False, person_thre=0.1,
        capacity=capacity, max_poses=max_poses))

    @jax.jit
    def oracle(padded):
        t = jencode_targets(padded, np.asarray(skeleton.sigmas),
                            skeleton.skeleton, 160, 160, enc_cfg)
        return pp._decode_body({'hmp': [t.hmp], 'jomp': [t.jomp],
                                'omp': [t.omp], 'scmp': [None]}, False)

    coco = JCocoJson(ann_file)
    ids = coco.image_ids(with_persons=True, with_keypoints=True)
    results = []
    for img_id in ids:
        info = coco.image_info(img_id)
        anns = JT.normalize_annotations(coco.anns_for_image(img_id),
                                        skeleton.sigmas)
        meta = JT.make_meta(info['width'], info['height'])
        dummy = np.zeros((info['height'], info['width'], 3), np.uint8)
        img2, anns, meta = JT.rescale_long_absolute(dummy, anns, meta, 640)
        _, anns, meta = JT.center_pad(img2, anns, meta, 640)
        padded = np.zeros((1, enc_cfg.max_persons, 17, 4), np.float32)
        padded[0, :min(len(anns), enc_cfg.max_persons)] = \
            anns[:enc_cfg.max_persons]
        poses, _, counts = oracle(jnp.asarray(padded))
        assert poses.shape[1] == min(capacity, max_poses)
        valid = np.asarray(poses[0])[:int(counts[0])]
        results.extend(jharness.poses_to_coco_results(
            JT.annotations_inverse(valid, meta), img_id))
    stats = jcocoeval.evaluate_coco_keypoints(coco, results, skeleton.sigmas,
                                              image_ids=ids)
    return stats, results


def record_set(results):
    """Records per image as tests/test_torch_port_eval.py compares them:
    keypoints exact (the records round x, y to 2 decimals), scores to 4
    decimals (a keypoint score may differ from JAX's in its last bit)."""
    by = {}
    for r in results:
        by.setdefault(r['image_id'], set()).add(
            (tuple(r['keypoints']), round(r['score'], 4)))
    return by


def test_crowd_oracle_over_capacity_matches_jax(tmp_path, monkeypatch):
    """Two crowd scenes, capacity 16, max_poses 40: the port's `simulate`
    on the CPU gives JAX's AP and JAX's records (every scene fills the 16
    rows, so the cut is live). Identical records, as
    tests/test_torch_port_eval.py counts them, and the same AP and AR."""
    ann = synthetic.write_annotations(str(tmp_path),
                                      synthetic.crowd_annotations(2, seed=0))
    ours = []

    def capture(poses, img_id, *args, **kwargs):
        out = to_records(poses, img_id, *args, **kwargs)
        ours.extend(out)
        return out
    to_records = harness.poses_to_coco_results
    monkeypatch.setattr(harness, 'poses_to_coco_results', capture)
    stats = simulate.main([
        '--annotation-file', ann, '--device', 'cpu',
        '--topk', str(CROWD_ORACLE['topk']),
        '--max-persons', str(CROWD_ORACLE['max_persons']),
        '--capacity', '16', '--max-poses', '40'])
    ref, ref_results = jax_crowd_oracle(ann, 16, 40)
    assert len(ref_results) == 2 * 16
    assert record_set(ours) == record_set(ref_results)
    assert abs(stats['AP'] - ref['AP']) < 1e-9
    assert abs(stats['AR'] - ref['AR']) < 1e-9
    assert 0.1 < stats['AP'] < 0.4
