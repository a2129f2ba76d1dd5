"""End to end on the CPU: a uint8 batch through `make_infer_fn` of the port
and of the JAX package gives the same COCO records (tiny widths, fp32,
`flip_test` passed explicitly on both sides), the port's serving Batcher
answers requests, the eval preprocessing matches, and no module of the
port imports JAX or the JAX package."""
import ast
import pathlib
import threading

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offsetguided_tpu.config.defaults import DecoderConfig as JDecoderConfig
from offsetguided_tpu.config.defaults import EvalConfig as JEvalConfig
from offsetguided_tpu.decoder import PostProcessor as JPostProcessor
from offsetguided_tpu.eval import harness as jharness
from offsetguided_tpu_torch.cli.serve import Batcher, build_infer, cli
from offsetguided_tpu_torch.config.defaults import DecoderConfig, EvalConfig
from offsetguided_tpu_torch.data import transforms as T
from offsetguided_tpu_torch.decoder import PostProcessor
from offsetguided_tpu_torch.eval import harness
from offsetguided_tpu_torch.models import PoseNet, state_dict_from_jax
from test_torch_port_model import random_variables, tiny

PKG = pathlib.Path(__file__).resolve().parents[1] / 'offsetguided_tpu_torch'
DEC = dict(topk=8, thre_hmp=0.04, dist_max=40.0, person_thre=0.01)


def record_sets(poses, counts, n):
    """Per image, the set of (rounded keypoints, score) COCO records."""
    out = []
    for i in range(n):
        recs = harness.poses_to_coco_results(
            np.asarray(poses[i])[:int(counts[i])], i)
        out.append({(tuple(np.round(r['keypoints'], 2)), round(r['score'], 4))
                    for r in recs})
    return out


@pytest.mark.parametrize('flip_test', [False, True])
def test_infer_records_match_jax(flip_test):
    jcfg, cfg = tiny()
    jmodel, variables = random_variables(jcfg, seed=2)
    net = PoseNet(cfg)
    net.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    net.prepare_inference()
    images = np.random.RandomState(4).randint(0, 256, (2, 64, 64, 3),
                                              dtype=np.uint8)
    jinfer = jharness.make_infer_fn(
        jmodel, variables, JPostProcessor(cfg=JDecoderConfig(**DEC)),
        flip_test=flip_test)
    infer = harness.make_infer_fn(
        net, PostProcessor(cfg=DecoderConfig(**DEC)), flip_test=flip_test)
    rp, _, rc = jinfer(jnp.asarray(images))
    p, _, c = infer(torch.from_numpy(images))
    np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
    assert c.sum() > 0
    # identical record sets: no tie flipped by the forward's summation order
    assert record_sets(p, c, 2) == record_sets(rp, rc, 2)


def test_preprocess_matches_jax():
    """Same geometry, meta and pixels as the JAX preprocessing. The
    port's resize gives cv2.INTER_CUBIC's values, on a smooth image and
    on noise, up- and downscaling (64x44 and 640x443 from 130x90)."""
    yy, xx = np.mgrid[0:90, 0:130]
    smooth = np.stack([xx * 1.9, yy * 2.7, (xx + yy) * 1.1], -1)
    smooth = np.clip(smooth, 0, 255).astype(np.uint8)
    anns = np.zeros((0, 17, 4), np.float32)
    cfg, jcfg = EvalConfig(long_edge=64), JEvalConfig(long_edge=64)
    img, _, meta = harness.preprocess_eval(smooth, anns, cfg)
    jimg, _, jmeta = jharness.preprocess_eval(smooth, anns, jcfg,
                                              normalize=False)
    assert img.shape == jimg.shape == (64, 64, 3) and img.dtype == np.uint8
    for key in ('offset', 'scale', 'valid_area', 'width_height'):
        np.testing.assert_allclose(meta[key], jmeta[key], err_msg=key)
    np.testing.assert_array_equal(img, jimg)
    noise = np.random.RandomState(0).randint(0, 256, (90, 130, 3), np.uint8)
    for tw, th in ((64, 44), (640, 443)):
        ours = T.resize_bicubic_u8(noise, tw, th)
        ref = cv2.resize(noise, (tw, th), interpolation=cv2.INTER_CUBIC)
        np.testing.assert_array_equal(ours, ref)


def test_batcher_answers_requests_on_cpu():
    args = cli(['--long-edge', '64', '--batch-size', '2',
                '--batch-window-ms', '20', '--topk', '8',
                '--person-thre', '0.01'])
    _, cfg = tiny()
    infer, skeleton, ecfg, _ = build_infer(args, cfg, device='cpu', seed=3)
    batcher = Batcher(infer, ecfg.batch_size, args.batch_window_ms, 'cpu')
    rng = np.random.RandomState(5)
    shapes = [(48, 64), (64, 40), (30, 90), (64, 64), (50, 50)]
    results = [None] * len(shapes)

    def request(i, shape):
        img = rng.randint(0, 256, shape + (3,), dtype=np.uint8)
        x, _, meta = harness.preprocess_eval(
            img, np.zeros((0, 17, 4), np.float32), ecfg)
        results[i] = batcher.submit(x, meta, timeout=60.0)

    threads = [threading.Thread(target=request, args=(i, s))
               for i, s in enumerate(shapes)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        batcher.close()
    assert all(r is not None and r.shape[1:] == (17, 6) for r in results)
    m = batcher.metrics()
    assert m['requests'] == len(shapes) and m['errors'] == 0
    assert m['batches'] >= 3         # at most 2 requests per batch


def test_port_imports_no_jax():
    """No module of the port, and neither `chip_smoke.py` nor
    `kernel_phases.py`, imports jax, flax or the JAX package (checked on the
    source: this interpreter may already hold jax)."""
    banned = ('jax', 'jaxlib', 'flax', 'optax', 'offsetguided_tpu')
    bad = []
    files = sorted(PKG.rglob('*.py')) + [PKG.parent / 'chip_smoke.py',
                                         PKG.parent / 'kernel_phases.py']
    assert len(files) > 15
    names = {str(f.relative_to(PKG)) for f in files if PKG in f.parents}
    assert {'cli/train.py', 'parallel/train_step.py', 'ops/augment.py',
            'ops/losses.py', 'data/pipeline.py', 'utils/meters.py',
            'utils/logging.py', 'cli/selfcheck.py', 'cli/bench_data.py',
            'data/pixels.py', 'config/crowdpose.py',
            'models/hourglass4stage.py', 'cli/demo.py', 'cli/export.py',
            'cli/bench_train.py', 'cli/bench_warp.py', 'cli/bench_stem.py',
            'visualization/show.py', 'parallel/distributed.py',
            'parallel/dryrun.py', 'parallel/parity.py'} <= names
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or '']
            bad += [(f.name, n) for n in names
                    if n.split('.')[0] in banned]
    assert not bad, bad


def test_default_device_is_the_card():
    """Entry points go to cuda unless told otherwise; no silent CPU path."""
    from offsetguided_tpu_torch.device import resolve_device
    assert resolve_device('cpu').type == 'cpu'
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device()


def test_build_hash_follows_included_headers(tmp_path, monkeypatch):
    """A kernel library's file name changes with the source, with every
    `csrc/*.cuh` header it includes (also through another header), and with
    nothing else."""
    from offsetguided_tpu_torch.ops.cuda import _build
    assert [f.name for f in _build._sources('topk')] == ['topk.cu',
                                                         'topk_select.cuh']
    monkeypatch.setattr(_build, 'CSRC', tmp_path)
    (tmp_path / 'k.cu').write_text('#include "a.cuh"\n#include <stdint.h>\n')
    (tmp_path / 'a.cuh').write_text('#pragma once\n  # include "b.cuh"\n')
    (tmp_path / 'b.cuh').write_text('int b;\n')
    (tmp_path / 'other.cuh').write_text('int other;\n')
    first = _build._target('k')
    (tmp_path / 'other.cuh').write_text('int other2;\n')
    assert _build._target('k') == first
    (tmp_path / 'b.cuh').write_text('int b2;\n')
    second = _build._target('k')
    assert second != first
    (tmp_path / 'k.cu').write_text('#include "a.cuh"\n// edit\n')
    assert _build._target('k') not in (first, second)
