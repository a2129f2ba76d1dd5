"""The port's CrowdPose 14-keypoint configuration against the JAX package on
the CPU: the config tables, `evaluate_crowdpose_keypoints`, the GT oracle
loop (encode -> decode -> inverse -> crowd-band AP) on the six scenes of
tests/test_crowdpose_e2e.py, the flip-merge round trip, the plain grouping
at J = 14, `cli.evaluate --dataset crowdpose` against JAX's `run_images`,
and one `cli.train --dataset crowdpose` step's losses against JAX's train
step. The scenes and the port's oracle loop come from `chip_smoke.py`,
which runs them on the card; the first tests hold them equal to the JAX
test's."""
import functools
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from offsetguided_tpu.config import crowdpose as jcp  # noqa: E402
from offsetguided_tpu.config.defaults import DecoderConfig as JDecoderConfig  # noqa: E402
from offsetguided_tpu.config.defaults import EncoderConfig as JEncoderConfig  # noqa: E402
from offsetguided_tpu.config.defaults import EvalConfig as JEvalConfig  # noqa: E402
from offsetguided_tpu.config.defaults import HeadsConfig as JHeadsConfig  # noqa: E402
from offsetguided_tpu.config.defaults import LossConfig as JLossConfig  # noqa: E402
from offsetguided_tpu.config.defaults import ModelConfig as JModelConfig  # noqa: E402
from offsetguided_tpu.config.defaults import SkeletonConfig as JSkeletonConfig  # noqa: E402
from offsetguided_tpu.config.defaults import TrainConfig as JTrainConfig  # noqa: E402
from offsetguided_tpu.data import transforms as JT  # noqa: E402
from offsetguided_tpu.data.coco import CocoJson as JCocoJson  # noqa: E402
from offsetguided_tpu.decoder import PostProcessor as JPostProcessor  # noqa: E402
from offsetguided_tpu.eval import cocoeval as jcocoeval  # noqa: E402
from offsetguided_tpu.eval import harness as jharness  # noqa: E402
from offsetguided_tpu.models import PoseNet as JPoseNet  # noqa: E402
from offsetguided_tpu.ops.encoder import downscale_mask as jdownscale_mask  # noqa: E402
from offsetguided_tpu.ops.encoder import encode_targets as jencode_targets  # noqa: E402
from offsetguided_tpu.ops.grouping import group_skeletons as jgroup  # noqa: E402
from offsetguided_tpu.parallel import create_train_state  # noqa: E402
from offsetguided_tpu.parallel import make_optimizer as jmake_optimizer  # noqa: E402
from offsetguided_tpu.parallel import make_train_step as jmake_train_step  # noqa: E402
from offsetguided_tpu_torch import config as cfgmod  # noqa: E402
from offsetguided_tpu_torch.cli import evaluate  # noqa: E402
from offsetguided_tpu_torch.cli import serve  # noqa: E402
from offsetguided_tpu_torch.cli import train as train_cli  # noqa: E402
from offsetguided_tpu_torch.config.defaults import (  # noqa: E402
    DecoderConfig, EncoderConfig, SkeletonConfig)
from offsetguided_tpu_torch.data import codec  # noqa: E402
from offsetguided_tpu_torch.decoder import PostProcessor  # noqa: E402
from offsetguided_tpu_torch.eval import cocoeval  # noqa: E402
from offsetguided_tpu_torch.models import PoseNet, random_posenet  # noqa: E402
from offsetguided_tpu_torch.models import checkpoint as ckpt  # noqa: E402
from offsetguided_tpu_torch.models.network import init_reference_  # noqa: E402
from offsetguided_tpu_torch.ops import grouping  # noqa: E402
from offsetguided_tpu_torch.ops.encoder import encode_targets  # noqa: E402
from test_crowdpose_e2e import crowdpose_json, make_persons  # noqa: E402,F401

SIGMAS = np.asarray(jcp.CROWDPOSE_SIGMAS)
J = 14


def test_config_tables_match_jax():
    assert cfgmod.CROWDPOSE_KEYPOINTS == jcp.CROWDPOSE_KEYPOINTS
    assert cfgmod.CROWDPOSE_SIGMAS == jcp.CROWDPOSE_SIGMAS
    assert cfgmod.CROWDPOSE_PERSON_SKELETON == jcp.CROWDPOSE_PERSON_SKELETON
    assert cfgmod.CROWDPOSE_HFLIP == jcp.CROWDPOSE_HFLIP
    np.testing.assert_array_equal(cfgmod.crowdpose_hflip_indices(),
                                  jcp.crowdpose_hflip_indices())
    for a, b in zip(cfgmod.crowdpose_offset_hflip(),
                    jcp.crowdpose_offset_hflip()):
        np.testing.assert_array_equal(a, b)
    ours, ref = SkeletonConfig.crowdpose(), JSkeletonConfig.crowdpose()
    assert (ours.keypoints, ours.sigmas, ours.skeleton, ours.hflip) == \
        (ref.keypoints, ref.sigmas, ref.skeleton, ref.hflip)
    assert (ours.n_keypoints, ours.n_limbs) == (14, 17)
    np.testing.assert_array_equal(ours.heatmap_flip_indices(),
                                  ref.heatmap_flip_indices())
    for a, b in zip(ours.offset_flip_indices(), ref.offset_flip_indices()):
        np.testing.assert_array_equal(a, b)


def test_scenes_equal_the_jax_test(crowdpose_json):
    """`chip_smoke.crowdpose_annotations` writes the JAX test's six-scene
    file; the generated scenes cover every crowdIndex band."""
    ann_file, gt_kps = crowdpose_json
    ours, kps = chip_smoke.crowdpose_annotations(chip_smoke.CROWDPOSE_SCENES)
    with open(ann_file) as f:
        assert json.load(f) == json.loads(json.dumps(ours))
    for i in gt_kps:
        np.testing.assert_array_equal(kps[i], gt_kps[i])
    np.testing.assert_array_equal(chip_smoke.crowdpose_persons(
        [(20, 30, 100), (85, 45, 60)], seed=3),
        make_persons([(20, 30, 100), (85, 45, 60)], seed=3))
    scenes = chip_smoke.crowdpose_scenes(12, seed=0)
    cis = [ci for ci, _ in scenes]
    assert min(cis) < 0.1 and max(cis) >= 0.8
    assert any(0.1 <= c < 0.8 for c in cis)


def noisy_results(gt_kps, rng):
    """Detections: each GT person moved by a few pixels, with a score, and
    a false positive per image."""
    out = []
    for img_id, kps in gt_kps.items():
        for k in kps:
            d = k.copy()
            d[:, :2] += rng.randn(J, 2) * 3.0
            out.append({'image_id': img_id, 'category_id': 1,
                        'keypoints': d.reshape(-1).tolist(),
                        'score': float(0.5 + 0.5 * rng.rand())})
        fp = np.zeros((J, 3), np.float32)
        fp[:, :2] = rng.rand(J, 2) * 300
        out.append({'image_id': img_id, 'category_id': 1,
                    'keypoints': fp.reshape(-1).tolist(), 'score': 0.3})
    return out


@pytest.mark.parametrize('ids', [None, [1, 3, 5], [1, 2]])
def test_evaluate_crowdpose_keypoints_matches_jax(crowdpose_json, ids):
    """AP and the three band APs equal JAX's on the six scenes, whole and
    restricted to an image set (two easy images: the other bands read
    -1.0)."""
    ann_file, gt_kps = crowdpose_json
    results = noisy_results(gt_kps, np.random.RandomState(0))
    ref = jcocoeval.evaluate_crowdpose_keypoints(ann_file, results, SIGMAS,
                                                 image_ids=ids)
    ours = cocoeval.evaluate_crowdpose_keypoints(ann_file, results, SIGMAS,
                                                 image_ids=ids)
    assert list(ours) == ['AP', 'AP_easy', 'AP_medium', 'AP_hard']
    assert ours == pytest.approx(ref, abs=1e-12)
    if ids == [1, 2]:
        assert ours['AP_medium'] == ours['AP_hard'] == -1.0
    else:
        assert all(0.0 < v < 1.0 for v in ours.values())


def by_image(results):
    by = {}
    for r in results:
        by.setdefault(r['image_id'], set()).add(
            (tuple(np.round(r['keypoints'], 2)), round(r['score'], 4)))
    return by


@functools.lru_cache(maxsize=None)
def jax_postprocessor(upsampled=True):
    return JPostProcessor(skeleton=JSkeletonConfig.crowdpose(),
                          cfg=JDecoderConfig(upsampled_decode=upsampled,
                                             **chip_smoke.CROWDPOSE_DECODE))


def jax_oracle(ann_file):
    """The JAX package's CrowdPose oracle loop, as
    tests/test_crowdpose_e2e.py runs it."""
    coco = JCocoJson(ann_file)
    pp, size = jax_postprocessor(), chip_smoke.CROWDPOSE_SIZE
    results = []
    for img_id in coco.image_ids(with_persons=True):
        info = coco.image_info(img_id)
        anns = JT.normalize_annotations(coco.anns_for_image(img_id),
                                        jcp.CROWDPOSE_SIGMAS, n_keypoints=J)
        meta = JT.make_meta(info['width'], info['height'])
        dummy = np.zeros((info['height'], info['width'], 3), np.uint8)
        img2, anns, meta = JT.rescale_long_absolute(dummy, anns, meta, size)
        _, anns, meta = JT.center_pad(img2, anns, meta, size)
        padded = np.zeros((8, J, 4), np.float32)
        padded[:len(anns)] = anns[:8]
        t = jencode_targets(jnp.asarray(padded[None]), SIGMAS,
                            jcp.CROWDPOSE_PERSON_SKELETON, size // 4,
                            size // 4, JEncoderConfig(max_persons=8))
        poses, _, counts = pp.decode(
            {'hmp': [t.hmp], 'bg': [None], 'jomp': [t.jomp],
             'omp': [t.omp], 'spread': [None], 'scmp': [None]})
        valid = np.asarray(poses[0])[:int(counts[0])]
        results.extend(jharness.poses_to_coco_results(
            JT.annotations_inverse(valid, meta), img_id))
    return results, jcocoeval.evaluate_crowdpose_keypoints(
        coco, results, SIGMAS)


def test_oracle_loop_matches_jax(crowdpose_json):
    """GT encode -> decode -> inverse -> crowd-band AP on the six scenes:
    the port's loop (`chip_smoke.crowdpose_oracle`, batches of 4, plain
    kernels on the CPU) gives JAX's records image for image and its APs;
    the stride-resolution decode scores every band too."""
    ann_file, _ = crowdpose_json
    ref_results, ref = jax_oracle(ann_file)
    results, stats, _ = chip_smoke.crowdpose_oracle(
        ann_file, torch.device('cpu'), batch=4)
    assert by_image(results) == by_image(ref_results)
    assert stats == pytest.approx(ref, abs=1e-12)
    assert stats['AP'] > 0.85 and min(stats.values()) > 0.75
    _, low, _ = chip_smoke.crowdpose_oracle(ann_file, torch.device('cpu'),
                                            upsampled=False)
    assert min(low.values()) > 0.5, low


def test_plain_grouping_at_j14_matches_jax(crowdpose_json):
    """The port's plain grouping on the oracle's packed limbs of two scenes
    (J = 14, L = 17) against the JAX grouping: counts identical, poses
    within 1e-4, scores within 1e-5."""
    size = chip_smoke.CROWDPOSE_SIZE
    anns = np.zeros((2, 8, J, 4), np.float32)
    for i, placements in enumerate(([(20, 30, 100), (85, 45, 60)],
                                    [(10, 20, 70), (60, 30, 80),
                                     (100, 10, 50)])):
        anns[i, :len(placements), :, :3] = make_persons(placements, seed=i)
        anns[i, :len(placements), :, 3] = 3.0
    sk = SkeletonConfig.crowdpose()
    t = encode_targets(anns, sk.sigmas, sk.skeleton, size // 4, size // 4,
                       EncoderConfig(max_persons=8))
    cfg = DecoderConfig(**chip_smoke.CROWDPOSE_DECODE)
    packed = PostProcessor(skeleton=sk, cfg=cfg).decode_packed_limbs(
        {'hmp': [t.hmp], 'jomp': [t.jomp], 'omp': [t.omp], 'scmp': [None]})
    assert tuple(packed.shape) == (2, 17, 12, 13)
    p, s, c = grouping.group_skeletons(packed, sk.skeleton, cfg, J)
    rp, rs, rc = jax.jit(functools.partial(
        jgroup, skeleton=sk.skeleton,
        cfg=JDecoderConfig(**chip_smoke.CROWDPOSE_DECODE), n_keypoints=J))(
            jnp.asarray(packed.numpy()))
    np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
    assert c.tolist() == [2, 3]
    np.testing.assert_allclose(p.numpy(), np.asarray(rp), rtol=0, atol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=0, atol=1e-5)


def test_flip_merge_roundtrip():
    """Decode with flip-test on an exactly flipped half-batch reproduces
    the decode without it: the CrowdPose keypoint and limb flip tables and
    the reserve rule end to end (tests/test_crowdpose_e2e.py's check)."""
    size = chip_smoke.CROWDPOSE_SIZE
    anns = np.zeros((1, 8, J, 4), np.float32)
    anns[0, :2, :, :3] = make_persons([(20, 30, 100), (85, 45, 60)], seed=3)
    anns[0, :2, :, 3] = 2.0
    sk = SkeletonConfig.crowdpose()
    pp = PostProcessor(skeleton=sk,
                       cfg=DecoderConfig(**chip_smoke.CROWDPOSE_DECODE))
    t = encode_targets(anns, sk.sigmas, sk.skeleton, size // 4, size // 4,
                       EncoderConfig(max_persons=8))
    kp_flip, limb_flip = pp._kp_flip, pp._limb_flip
    L = len(limb_flip)

    def flipped(x, kind):
        f = torch.flip(x, dims=(2,))
        if kind == 'hmp':
            return f[..., kp_flip]
        if kind == 'jomp':
            return f * torch.tensor([-1.0, 1.0])
        n, h, w, _ = f.shape
        f5 = f.reshape(n, h, w, L, 2) * torch.tensor([-1.0, 1.0])
        return f5[..., limb_flip, :].reshape(n, h, w, 2 * L)

    maps = {'hmp': t.hmp, 'jomp': t.jomp, 'omp': t.omp}
    doubled = {k: [torch.cat([v, flipped(v, k)])] for k, v in maps.items()}
    doubled['scmp'] = [None]
    single = {k: [v] for k, v in maps.items()}
    single['scmp'] = [None]
    ref, _, rc = pp.decode_body(single, flip_test=False)
    got, _, gc = pp.decode_body(doubled, flip_test=True)
    assert int(gc[0]) == int(rc[0]) == 2
    np.testing.assert_allclose(got[0, :2, :, :2].numpy(),
                               ref[0, :2, :, :2].numpy(), atol=1e-3)


@pytest.fixture(scope='module')
def crowdpose_set(tmp_path_factory):
    """The six scenes as 320x256 PNGs (the port's codec and cv2 read the
    same pixels), painted grey with the persons' joints."""
    root = tmp_path_factory.mktemp('cp_set')
    ann, gt_kps = chip_smoke.crowdpose_annotations(
        chip_smoke.CROWDPOSE_SCENES, ext='png')
    (root / 'images').mkdir()
    rng = np.random.RandomState(0)
    for im in ann['images']:
        img = (rng.rand(256, 320, 3) * 60 + 90).astype(np.uint8)
        for x, y, _ in gt_kps[im['id']].reshape(-1, 3):
            img[max(int(y) - 2, 0):int(y) + 3,
                max(int(x) - 2, 0):int(x) + 3] = (60, 200, 60)
        (root / 'images' / im['file_name']).write_bytes(codec.encode_png(img))
    path = root / 'annotations.json'
    path.write_text(json.dumps(ann))
    return str(root / 'images'), str(path)


def test_evaluate_cli_crowdpose_matches_jax(crowdpose_set, tmp_path, capsys):
    """`cli.evaluate --dataset crowdpose --debug-tiny-model` (long edge 320,
    no resize, batch 2): the four band lines, 14-keypoint records equal to
    JAX `run_images`'s with the same weights, image for image."""
    img_dir, ann = crowdpose_set
    out = tmp_path / 'res.json'
    argv = ['--image-dir', img_dir, '--annotation-file', ann, '--device',
            'cpu', '--dataset', 'crowdpose', '--debug-tiny-model',
            '--long-edge', '320', '--batch-size', '2', '--io-workers', '2',
            '--results-json', str(out)]
    stats = evaluate.main(argv)
    printed = capsys.readouterr().out
    for key in ('AP:', 'AP_easy:', 'AP_medium:', 'AP_hard:'):
        assert key in printed, printed
    assert set(stats) == {'AP', 'AP_easy', 'AP_medium', 'AP_hard',
                          'img_per_s'}
    ours = json.loads(out.read_text())
    assert all(len(r['keypoints']) == J * 3 for r in ours)

    args = evaluate.cli(argv)
    cfg = evaluate.model_config(args)
    assert (cfg.heads.n_keypoints, cfg.heads.n_limbs) == (14, 17)
    net = random_posenet(cfg, 0, device='cpu', calib_size=320)
    variables = ckpt.jax_from_state_dict(net.state_dict(), cfg)
    jcfg = JModelConfig(n_stacks=1, hg_order=2, dims=(8, 8, 12),
                        modules=(1, 1, 1), cnv_dim=8, compute_dtype='float32',
                        heads=JHeadsConfig(n_keypoints=14, n_limbs=17))
    ref = jharness.run_images(
        JPoseNet(jcfg), variables, JPostProcessor(
            skeleton=JSkeletonConfig.crowdpose(), cfg=JDecoderConfig(
                topk=args.topk, thre_hmp=args.thre_hmp,
                dist_max=args.dist_max, person_thre=args.person_thre)),
        JCocoJson(ann), img_dir, JEvalConfig(long_edge=320, flip_test=False,
                                             batch_size=2),
        skeleton=JSkeletonConfig.crowdpose())
    assert by_image(ours) == by_image(ref)
    assert sum(len(v) for v in by_image(ref).values()) > 6   # real poses


def test_serve_crowdpose_answers_14_keypoints():
    """`cli.serve --dataset crowdpose`: the skeleton and heads follow the
    dataset, and the batched infer function returns 14-keypoint poses."""
    args = serve.cli(['--dataset', 'crowdpose', '--debug-tiny-model',
                      '--long-edge', '128', '--batch-size', '2', '--device',
                      'cpu'])
    infer, skeleton, ecfg, model = serve.build_infer(args, device='cpu')
    assert skeleton.n_keypoints == 14
    assert model.cfg.heads.n_keypoints == 14 and model.cfg.heads.n_limbs == 17
    poses, _, counts = infer(torch.zeros((2, 128, 128, 3), dtype=torch.uint8))
    assert tuple(poses.shape[2:]) == (14, 6)


def test_cli_train_crowdpose_step_matches_jax(tmp_path, monkeypatch):
    """One `cli.train --dataset crowdpose --debug-tiny-model` step on the
    host route (scale 0.4-0.5, so the scenes stay in view of the 128^2
    crop and every loss term has targets): 14 / 17 heads, and the losses
    equal the JAX train step's on the same batch and initial weights
    within 1e-4 relative."""
    root = tmp_path / 'cp'
    (root / 'images').mkdir(parents=True)
    ann, _ = chip_smoke.crowdpose_annotations(chip_smoke.CROWDPOSE_SCENES[:2],
                                              ext='npy')
    rng = np.random.RandomState(1)
    for im in ann['images']:
        np.save(root / 'images' / im['file_name'],
                (rng.rand(256, 320, 3) * 255).astype(np.uint8))
    (root / 'ann.json').write_text(json.dumps(ann))
    seen = []
    feed = train_cli.device_batch

    def spy(batch, *a, **kw):
        seen.append({k: np.array(v) for k, v in batch.items()})
        return feed(batch, *a, **kw)

    monkeypatch.setattr(train_cli, 'device_batch', spy)
    r = train_cli.main([
        '--device', 'cpu', '--debug-tiny-model', '--dataset', 'crowdpose',
        '--n-stacks', '1', '--train-image-dir', str(root / 'images'),
        '--train-annotations', str(root / 'ann.json'), '--batch-size', '2',
        '--square-length', '128', '--max-persons', '4', '--print-freq', '1',
        '--max-steps', '1', '--checkpoint-dir', str(tmp_path / 'ckpt'),
        '--min-scale', '0.4', '--max-scale', '0.5', '--max-translate', '10'])
    cfg = r['model_cfg']
    assert (cfg.heads.n_keypoints, cfg.heads.n_limbs) == (14, 17)
    h = r['history'][0]
    assert h['skipped'] == 0.0

    init = init_reference_(PoseNet(cfg), torch.Generator().manual_seed(0))
    variables = ckpt.jax_from_state_dict(init.state_dict(), cfg)
    jcfg = JModelConfig(n_stacks=1, hg_order=2, dims=(16, 16, 24),
                        modules=(1, 1, 1), cnv_dim=16, compute_dtype='float32',
                        heads=JHeadsConfig(n_keypoints=14, n_limbs=17))
    batch = seen[0]
    assert batch['anns'].shape == (2, 4, 14, 4)
    enc = JEncoderConfig(max_persons=4)
    targets = jencode_targets(jnp.asarray(batch['anns']), SIGMAS,
                              jcp.CROWDPOSE_PERSON_SKELETON, 32, 32, enc)
    tx = jmake_optimizer(JTrainConfig(optimizer='sgd'))
    _, jm = jax.jit(jmake_train_step(JPoseNet(jcfg), tx, JLossConfig(
        stack_weights=(1.0,))))(create_train_state(variables, tx),
                                jnp.asarray(batch['image']), targets,
                                jdownscale_mask(jnp.asarray(
                                    batch['mask_miss']), enc))
    for k in ('total', 'hmp', 'omp', 'scmp'):
        np.testing.assert_allclose(h[k], float(jm[k]), rtol=1e-4, err_msg=k)
    assert float(jm['hmp']) > 0 and float(jm['omp']) > 0
