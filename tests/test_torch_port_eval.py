"""The port's evaluation slice against the JAX package on the CPU: fixed-
height preprocessing, the OKS evaluator, the GT encoder, `run_images` in
fixed-height mode (batched equal to batch 1, and equal to JAX's records)
and a `cli.evaluate` smoke run. The oracle is in
tests/test_torch_port_oracle.py."""
import json

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offsetguided_tpu.config import COCO_PERSON_SIGMAS, COCO_PERSON_SKELETON
from offsetguided_tpu.config.defaults import DecoderConfig as JDecoderConfig
from offsetguided_tpu.config.defaults import EncoderConfig as JEncoderConfig
from offsetguided_tpu.config.defaults import EvalConfig as JEvalConfig
from offsetguided_tpu.data.coco import CocoJson as JCocoJson
from offsetguided_tpu.decoder import PostProcessor as JPostProcessor
from offsetguided_tpu.eval import cocoeval as jcocoeval
from offsetguided_tpu.eval import harness as jharness
from offsetguided_tpu.ops.encoder import encode_targets as jencode_targets
from offsetguided_tpu_torch.cli import evaluate
from offsetguided_tpu_torch.config.defaults import (DecoderConfig,
                                                    EncoderConfig, EvalConfig)
from offsetguided_tpu_torch.data import synthetic
from offsetguided_tpu_torch.data.coco import CocoJson
from offsetguided_tpu_torch.decoder import PostProcessor
from offsetguided_tpu_torch.eval import cocoeval, harness
from offsetguided_tpu_torch.models import PoseNet, state_dict_from_jax
from offsetguided_tpu_torch.ops.encoder import encode_targets
from test_cocoeval import dt_at, dt_from_gt, make_crowd_gt, make_gt
from test_torch_port_model import random_variables, tiny

# the suite's worker processes share the host's cores
torch.set_num_threads(2)

SIGMAS = np.asarray(COCO_PERSON_SIGMAS)


def smooth_image(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 1.9, yy * 2.7, (xx + yy) * 1.1], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize('h,w', [(90, 130), (130, 60), (64, 200)])
def test_fixed_height_preprocess_matches_jax(h, w):
    """Same padded shape, meta and pixels (the port's resize gives
    cv2.INTER_CUBIC's values)."""
    kw = dict(long_edge=64, fixed_height=True, max_stride=32,
              width_bucket=64)
    anns = np.zeros((0, 17, 4), np.float32)
    img, _, meta = harness.preprocess_eval(smooth_image(h, w), anns,
                                           EvalConfig(**kw))
    jimg, _, jmeta = jharness.preprocess_eval(smooth_image(h, w), anns,
                                              JEvalConfig(**kw),
                                              normalize=False)
    assert img.shape == jimg.shape and img.shape[1] % 64 == 0
    assert img.shape[0] == 64 and img.dtype == np.uint8
    assert meta.keys() == jmeta.keys()
    for key in meta:
        np.testing.assert_array_equal(meta[key], jmeta[key], err_msg=key)
    np.testing.assert_array_equal(img, jimg)
    bad = EvalConfig(**dict(kw, width_bucket=48))
    with pytest.raises(ValueError):
        harness.preprocess_eval(smooth_image(h, w), anns, bad)


def _scenario(kind, rng):
    """(gts_by_img, dts_by_img) in the manner of tests/test_cocoeval.py."""
    gts, dts = {}, {}
    for img in range(4):
        g = make_gt(rng, img, 2, area=float(rng.choice([2000, 8000, 90000])))
        gts[img] = g
        if kind == 'noisy':
            dts[img] = [dt_from_gt(x, score=0.5 + 0.4 * rng.rand(),
                                   noise=8.0, rng=rng) for x in g]
        elif kind == 'partial_fp':
            dts[img] = [dt_from_gt(g[0], score=0.9),
                        dt_at(img, 5000.0, 5000.0, 0.8),
                        dt_at(img, 1000.0, 1000.0, 0.99)]
        elif kind == 'crowd_empty':
            gts[img] = g + [make_crowd_gt(img, 900 + img),
                            {'id': 950 + img, 'image_id': img,
                             'keypoints': [0.0] * 51, 'num_keypoints': 0,
                             'area': 10000.0, 'iscrowd': 0,
                             'bbox': [600.0, 600.0, 100.0, 100.0]}]
            dts[img] = [dt_from_gt(x, score=0.9, noise=3.0, rng=rng)
                        for x in g] + [dt_at(img, 350.0, 350.0, 0.95)]
    return gts, dts


@pytest.mark.parametrize('kind', ['noisy', 'partial_fp', 'crowd_empty'])
def test_cocoeval_matches_jax(kind, tmp_path):
    gts, dts = _scenario(kind, np.random.RandomState(0))
    ref = jcocoeval.KeypointEval(COCO_PERSON_SIGMAS).run(gts, dts)
    ours = cocoeval.KeypointEval(COCO_PERSON_SIGMAS).run(gts, dts)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert abs(ours[k] - ref[k]) < 1e-9, (k, ours[k], ref[k])
    # the file entry point with an image-id restriction
    images = [{'id': i, 'file_name': f'{i}.jpg', 'height': 500, 'width': 500}
              for i in gts]
    anns = [dict(g, id=n, category_id=1) for n, g in
            enumerate((g for i in gts for g in gts[i]), start=1)]
    f = tmp_path / 'gt.json'
    f.write_text(json.dumps({'images': images, 'annotations': anns,
                             'categories': [{'id': 1, 'name': 'person'}]}))
    results = [d for i in dts for d in dts[i]]
    ref = jcocoeval.evaluate_coco_keypoints(str(f), results, SIGMAS, [0, 2])
    ours = cocoeval.evaluate_coco_keypoints(str(f), results, SIGMAS, [0, 2])
    for k in ref:
        assert abs(ours[k] - ref[k]) < 1e-9, (k, ours[k], ref[k])


def test_encoder_matches_jax():
    """Targets within 1e-6 and identical +inf / NaN sentinel masks, with
    exact-tie persons, invisible keypoints, small scales (NaN labels) and
    padding slots."""
    rng = np.random.RandomState(0)
    N, P, J = 2, 6, 17
    anns = np.zeros((N, P, J, 4), np.float32)
    anns[..., 0] = rng.rand(N, P, J) * 120
    anns[..., 1] = rng.rand(N, P, J) * 90
    anns[..., 2] = (rng.rand(N, P, J) < 0.8) * 2.0
    anns[..., 3] = rng.rand(N, P, J) * 3
    anns[:, 4:] = 0.0                                 # padding slots
    anns[0, 1, :, :2] = anns[0, 0, :, :2]             # exact ties
    cfg = dict(max_persons=P)
    ref = jencode_targets(jnp.asarray(anns), SIGMAS, COCO_PERSON_SKELETON,
                          24, 32, JEncoderConfig(**cfg))
    ours = encode_targets(anns, SIGMAS, COCO_PERSON_SKELETON, 24, 32,
                          EncoderConfig(**cfg))
    for name in ref._fields:
        a, b = np.asarray(getattr(ref, name)), getattr(ours, name).numpy()
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b), err_msg=name)
        fin = np.isfinite(a)
        np.testing.assert_allclose(b[fin], a[fin], rtol=0, atol=1e-6,
                                   err_msg=name)
    assert np.isinf(np.asarray(ref.omp)).any()
    assert np.isnan(np.asarray(ref.scmp)).any()


def _fixed_height_set(tmp_path, widths=(100, 70, 120, 40, 100)):
    """Images of height 64 (no rescale at long edge 64, so cv2 and torch
    resizes agree exactly) in two width buckets, out of aspect order:
    .npy for the port, lossless .png for the JAX harness."""
    img_dir = tmp_path / 'images'
    img_dir.mkdir()
    rng = np.random.RandomState(1)
    images, anns = [], []
    for i, w in enumerate(widths, start=1):
        img = (rng.rand(64, w, 3) * 255).astype(np.uint8)
        np.save(img_dir / f'{i:06d}.npy', img)
        cv2.imwrite(str(img_dir / f'{i:06d}.png'), img[..., ::-1])
        images.append({'id': i, 'file_name': f'{i:06d}.npy', 'height': 64,
                       'width': w})
        kps = []
        for j in range(17):
            kps += [float(10 + (j % 5) * 8), float(10 + (j // 5) * 9), 2]
        anns.append({'id': i, 'image_id': i, 'category_id': 1,
                     'keypoints': kps, 'num_keypoints': 17, 'iscrowd': 0,
                     'bbox': [8.0, 8.0, 40.0, 40.0], 'area': 1600.0})
    ds = {'images': images, 'annotations': anns,
          'categories': [{'id': 1, 'name': 'person'}]}
    (tmp_path / 'ann.json').write_text(json.dumps(ds))
    for im in images:
        im['file_name'] = im['file_name'].replace('.npy', '.png')
    (tmp_path / 'ann_png.json').write_text(json.dumps(ds))
    return str(img_dir), str(tmp_path / 'ann.json'), str(
        tmp_path / 'ann_png.json')


def _by_image(records):
    by = {}
    for r in records:
        by.setdefault(r['image_id'], set()).add(
            (tuple(np.round(r['keypoints'], 2)), round(r['score'], 4)))
    return by


def test_run_images_fixed_height_matches_batch1_and_jax(tmp_path):
    img_dir, ann, ann_png = _fixed_height_set(tmp_path)
    jcfg, cfg = tiny()
    jmodel, variables = random_variables(jcfg, seed=2)
    net = PoseNet(cfg)
    net.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    net.prepare_inference()
    dec = dict(topk=8, thre_hmp=0.04, dist_max=40.0, person_thre=0.01)
    ekw = dict(long_edge=64, fixed_height=True, max_stride=32,
               width_bucket=64, flip_test=False)
    coco = CocoJson(ann)
    pp = PostProcessor(cfg=DecoderConfig(**dec))
    b1 = _by_image(harness.run_images(net, pp, coco, img_dir,
                                      EvalConfig(batch_size=1, **ekw)))
    b3 = _by_image(harness.run_images(net, pp, coco, img_dir,
                                      EvalConfig(batch_size=3, **ekw)))
    assert set(b1) == set(b3) == {1, 2, 3, 4, 5}
    assert b1 == b3
    # JAX on the first three images, one batch of one padded shape (each
    # shape is a 20 s compile)
    ref = _by_image(jharness.run_images(
        jmodel, variables, JPostProcessor(cfg=JDecoderConfig(**dec)),
        JCocoJson(ann_png), img_dir, JEvalConfig(batch_size=3, **ekw),
        n_images=3))
    assert set(ref) == {1, 2, 3}
    assert all(b3[i] == ref[i] for i in ref)
    assert sum(len(v) for v in ref.values()) > 3    # real poses, not dummies


def test_evaluate_cli_smoke(tmp_path):
    """`cli.evaluate.main` on the CPU over .npy images: fixed height with
    flip-test, then stride-resolution decode from a reference-style
    checkpoint (`module.`-prefixed state dict); every image gets a
    record."""
    img_dir, ann = synthetic.make_hard_dataset(str(tmp_path), n_images=3,
                                               seed=1, ext='npy')
    args = ['--image-dir', img_dir, '--annotation-file', ann, '--device',
            'cpu', '--debug-tiny-model', '--long-edge', '128',
            '--max-stride', '32', '--width-bucket', '64', '--batch-size', '2',
            '--io-workers', '2']
    out = tmp_path / 'results.json'
    stats = evaluate.main(args + ['--fixed-height', '--flip-test',
                                  '--results-json', str(out)])
    assert set(stats) >= {'AP', 'AR'} and all(np.isfinite(list(stats.values())))
    assert {r['image_id'] for r in json.loads(out.read_text())} == {1, 2, 3}

    net = PoseNet(evaluate.model_config(evaluate.cli(args)))
    ckpt = tmp_path / 'ref.pth'
    torch.save({'epoch': 0, 'model_state_dict': {
        f'module.{k}': v for k, v in net.state_dict().items()}}, ckpt)
    stats = evaluate.main(args + ['--lowres-decode', '--torch-checkpoint',
                                  str(ckpt)])
    assert set(stats) >= {'AP', 'AR'}
