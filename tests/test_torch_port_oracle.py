"""The hard-synthetic oracle (GT encode -> decode -> OKS AP, no network)
through the port's `cli.simulate` on the CPU equals the JAX package's oracle
on the 8-image subset of tests/test_hard_synth.py, and the port's generator
builds the JAX generator's exact annotations."""
import json

import jax
import jax.numpy as jnp
import numpy as np

from offsetguided_tpu.config import COCO_PERSON_SIGMAS
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
from offsetguided_tpu_torch.data import synthetic

SIGMAS = np.asarray(COCO_PERSON_SIGMAS)


def _jax_oracle_ap(ann_file, max_persons):
    """The JAX package's oracle (cli/simulate.py's loop) at the given
    config, flip off, upsampled decode."""
    skeleton = JSkeletonConfig()
    enc_cfg = JEncoderConfig(max_persons=max_persons)
    pp = JPostProcessor(skeleton=skeleton, cfg=JDecoderConfig(
        topk=32, thre_hmp=0.04, dist_max=40.0, use_scale=False,
        person_thre=0.1))

    @jax.jit
    def oracle(padded):
        t = jencode_targets(padded, SIGMAS, skeleton.skeleton, 160, 160,
                            enc_cfg)
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
        padded = np.zeros((1, max_persons, 17, 4), np.float32)
        padded[0, :min(len(anns), max_persons)] = anns[:max_persons]
        poses, _, counts = oracle(jnp.asarray(padded))
        valid = np.asarray(poses[0])[:int(counts[0])]
        results.extend(jharness.poses_to_coco_results(
            JT.annotations_inverse(valid, meta), img_id))
    return jcocoeval.evaluate_coco_keypoints(coco, results, skeleton.sigmas,
                                             image_ids=ids)['AP']


def test_oracle_matches_jax(tmp_path):
    """The 8-image hard set: the port builds the JAX generator's exact
    annotations, and the port's `cli.simulate` (CPU, plain kernels) gives
    JAX's oracle AP."""
    _, jann = jsynthetic.make_hard_dataset(str(tmp_path / 'jax'), n_images=8,
                                           seed=0, paint=False)
    ours = synthetic.hard_annotations(8, seed=0)
    with open(jann) as f:
        assert json.load(f) == ours
    ann = synthetic.write_annotations(str(tmp_path / 'port'), ours)
    stats = simulate.main(['--annotation-file', ann, '--device', 'cpu',
                           '--thre-hmp', '0.04', '--max-persons', '16'])
    ref = _jax_oracle_ap(jann, 16)
    assert ref > 0.65
    assert abs(stats['AP'] - ref) < 1e-4, (stats['AP'], ref)
