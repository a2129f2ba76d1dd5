"""The 4-stack 4-stage hourglass (SimplePose's IMHN) on the port's serving
path, CPU only: the serve and evaluate flags that pick it, its forward as
`build_infer` prepares it against the benchmark's plain reference, one
served answer against the reference's decode of the program's own maps,
and the per-layer readers of its device stages (`net.dilated`,
`net.se`). Imports no JAX."""
from __future__ import annotations

import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from offsetguided_tpu_torch.cli import evaluate, serve
from offsetguided_tpu_torch.config.defaults import (EvalConfig, HeadsConfig,
                                                    ModelConfig)
from offsetguided_tpu_torch.eval.harness import preprocess_eval
from offsetguided_tpu_torch.models import PoseNet
from offsetguided_tpu_torch.utils import profiling
from offsetguided_tpu_torch.utils.profiling import RECORDER, Recorder

torch.set_num_threads(2)

BENCH = Path(__file__).resolve().parents[1] / 'benchmark'
CFG = json.loads((BENCH / 'configs' / 'imhn4-coco.json').read_text())
SIZE = 128                      # a multiple of the net's stride of 64
HEADS = ('hmp', 'bg', 'jomp', 'omp', 'scmp')


@pytest.fixture(scope='module')
def bench():
    """The benchmark's modules (`harness`, `reference`, `compare`, `tap`,
    `scenes`), imported from its directory for this module's tests and
    dropped afterwards, so that their top-level names leave no trace."""
    before = set(sys.modules)
    sys.path.insert(0, str(BENCH))
    try:
        import compare
        import harness
        import reference
        import scenes
        import tap
        from reference.model import PlainPoseNet, make_weights, normalize
        yield dict(compare=compare, harness=harness, reference=reference,
                   scenes=scenes, tap=tap, PlainPoseNet=PlainPoseNet,
                   make_weights=make_weights, normalize=normalize)
    finally:
        sys.path.remove(str(BENCH))
        for name in set(sys.modules) - before:
            if not name.startswith(('offsetguided_tpu_torch', 'torch')):
                del sys.modules[name]


def _serve_args(*extra):
    return serve.cli(['--long-edge', str(SIZE), '--batch-size', '2',
                      '--device', 'cpu', *extra])


# -- (a) the flags -----------------------------------------------------------

COCO = HeadsConfig(n_keypoints=17, n_limbs=19)
CROWD = HeadsConfig(n_keypoints=14, n_limbs=17)
FLAG_CASES = {
    'serve-4stage-coco': (
        'serve', ['--basenet', 'hourglass4stage', '--n-stacks', '4'],
        ModelConfig(basenet='hourglass4stage', n_stacks=4, heads=COCO)),
    'serve-4stage-crowdpose': (
        'serve', ['--basenet', 'hourglass4stage', '--n-stacks', '4',
                  '--dataset', 'crowdpose'],
        ModelConfig(basenet='hourglass4stage', n_stacks=4, heads=CROWD)),
    'serve-4stage-published-depth': (
        'serve', ['--basenet', 'hourglass4stage'],
        ModelConfig(basenet='hourglass4stage', n_stacks=4, heads=COCO)),
    'serve-defaults': ('serve', [], ModelConfig(heads=COCO)),
    'serve-tiny': (
        'serve', ['--debug-tiny-model'],
        ModelConfig(n_stacks=1, hg_order=2, dims=(8, 8, 12),
                    modules=(1, 1, 1), cnv_dim=8, compute_dtype='float32',
                    heads=COCO)),
    'evaluate-4stage-coco': (
        'evaluate', ['--basenet', 'hourglass4stage', '--n-stacks', '4'],
        ModelConfig(basenet='hourglass4stage', n_stacks=4, heads=COCO)),
    'evaluate-defaults': ('evaluate', [], ModelConfig(heads=COCO)),
}


@pytest.mark.parametrize('case', sorted(FLAG_CASES))
def test_network_flags_give_the_model_config(case):
    tool, argv, want = FLAG_CASES[case]
    if tool == 'serve':
        args = serve.cli(argv)
        from offsetguided_tpu_torch.config.defaults import SkeletonConfig
        got = serve.model_config(args,
                                 SkeletonConfig.for_dataset(args.dataset))
    else:
        got = evaluate.model_config(evaluate.cli(
            ['--image-dir', 'i', '--annotation-file', 'a'] + argv))
    assert got == want


def test_reference_checkpoint_is_refused_for_the_4stage_net(tmp_path):
    args = serve.cli(['--basenet', 'hourglass4stage', '--torch-checkpoint',
                      str(tmp_path / 'x.pth')])
    with pytest.raises(ValueError, match='Hourglass-104'):
        serve.load_weights(args, serve.model_config(args))


def test_tiny_model_is_refused_for_the_4stage_net():
    with pytest.raises(ValueError, match='fixed widths'):
        serve.model_config(serve.cli(['--basenet', 'hourglass4stage',
                                      '--debug-tiny-model']))


def test_a_tool_without_the_flags_gets_hourglass104():
    """Tools that share `serve.model_config` with their own flags (bench,
    profile_forward) have no `--basenet`: Hourglass-104 as before."""
    import argparse
    args = argparse.Namespace(debug_tiny_model=False)
    assert serve.model_config(args) == ModelConfig()


# -- (b) the forward against the plain reference ----------------------------

@pytest.fixture(scope='module')
def served(bench):
    """The cell's configuration in fp32 at SIZE^2: seeded weights from the
    benchmark's `make_weights`, BatchNorm calibrated by the plain network,
    the port's infer from `build_infer` (BatchNorm folded,
    channels_last), and both networks' maps of two seeded images."""
    cfg = dict(CFG, compute_dtype='float32')
    sd = bench['make_weights'](cfg, 2 ** 31 + 21, 'cpu')
    g = torch.Generator().manual_seed(21)
    noise = torch.randint(0, 256, (4, SIZE, SIZE, 3), generator=g,
                          dtype=torch.uint8)
    norm = bench['normalize']
    bench['PlainPoseNet'](cfg, sd).calibrate_(
        norm(noise, cfg['pixel_mean'], cfg['pixel_std']))
    args = _serve_args('--basenet', 'hourglass4stage', '--n-stacks', '4')
    infer, _, _, model = serve.build_infer(
        args, bench['harness'].model_config(cfg), sd, 'cpu')
    x = norm(torch.randint(0, 256, (2, SIZE, SIZE, 3), generator=g,
                           dtype=torch.uint8),
             cfg['pixel_mean'], cfg['pixel_std'])
    with torch.inference_mode():
        port = model(x)
    ref = bench['PlainPoseNet'](cfg, sd)(x)
    return dict(cfg=cfg, sd=sd, infer=infer, model=model, port=port, ref=ref)


def test_build_infer_prepares_the_4stack_net(served):
    m = served['model']
    assert m.cfg.basenet == 'hourglass4stage' and m.cfg.n_stacks == 4
    assert len(m.basenet.hgs) == 4
    assert not m.training
    conv = m.basenet.stem.dilated[0].conv
    assert conv.bias is not None            # BatchNorm folded into it
    assert conv.weight.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize('head', HEADS)
def test_4stack_maps_equal_the_plain_reference(served, head):
    """Every stack's map of one head within 1e-3 relative L2 of the plain
    network's: both fp32, apart only in the BatchNorm folding and the
    summation order (a bf16 forward reads about 1e-2)."""
    port, ref = served['port'][head], served['ref'][head]
    assert len(port) == len(ref) == 4
    for p, r in zip(port, ref):
        assert p.shape == r.shape
        assert float((p - r).norm() / r.norm()) < 1e-3


# -- (c) one served answer ---------------------------------------------------

def test_served_answer_equals_the_reference_decode_of_the_program_maps(
        served, bench):
    """One `Batcher.submit` through the 4-stack infer: its poses, in the
    scene's pixels, are the benchmark's reference decode of the maps the
    program computed for that batch, mapped back by the reference, to
    0.01 px (the cell's `decode_mismatch` and `answer_mismatch`)."""
    ref_mod, compare = bench['reference'], bench['compare']
    cfg, infer = served['cfg'], served['infer']
    img, _ = bench['scenes'].scene(bench['scenes'].rng_for(2 ** 31 + 5, 1),
                                   96, SIZE)
    J = len(cfg['keypoints'])
    frame, _, meta = preprocess_eval(
        img, np.zeros((0, J, 4), np.float32),
        EvalConfig(long_edge=SIZE, batch_size=2), J)
    canvas, origin = ref_mod.pad_long_edge(img, SIZE)
    assert np.array_equal(frame, canvas)
    maps = []
    hook = infer.model.register_forward_hook(
        lambda _, __, out: maps.append({k: v[-1].clone() for k, v in
                                        out.items() if v[-1] is not None}))
    batcher = serve.Batcher(infer, 2, 5.0, 'cpu')
    try:
        answer = batcher.submit(frame, meta)
    finally:
        batcher.close()
        hook.remove()
    assert len(maps) == 1
    pp = ref_mod.decode.PostProcessor(
        skeleton=ref_mod.skeleton(cfg),
        cfg=ref_mod.decoder_config(cfg, False))
    preds = {k: [maps[0][k]] if k in maps[0] else [None]
             for k in bench['tap'].MAP_KEYS}
    poses, _, counts = pp.decode_body(preds, flip_test=False)
    want = ref_mod.to_image(poses[0][:int(counts[0])].numpy(), origin)
    assert len(want) > 0
    assert len(answer) == len(want)
    assert compare.mismatch(compare.from_poses(answer),
                            compare.from_poses(want), 0.01) == 0


# -- (d) the device stages and their readers --------------------------------

def _reader(bench, name):
    return bench['harness'].metric_reader(name)


READERS = ('dilated_ms.infer', 'se_ms.infer', 'se_roofline')


@pytest.mark.parametrize('name', READERS)
def test_stage_readers_give_none_without_records(monkeypatch, bench, name):
    rec = Recorder()
    rec.add_span('serve.stack', 0.0, 0.5, 0)        # a batch, no stages
    monkeypatch.setattr(profiling, 'RECORDER', rec)
    reader = _reader(bench, name)
    assert reader.read({'t0': 0.0, 'seconds': 1.0}) is None
    assert reader.read({'t0': 5.0, 'seconds': 1.0}) is None


def _hand_made(monkeypatch):
    """Batches 0-5 start at second b; 0 and 4 sampled (4 SE stages and one
    dilated stem each), 8 outside the window [0, 6)."""
    rec = Recorder()
    se = (8, 256, 160, 160)
    for b in range(9):
        rec.add_span('serve.stack', b, b + 0.5, b)
    for b, scale in ((0, 1.0), (4, 2.0), (8, 100.0)):
        rec.stages.append((b, 'net.dilated', 1.5 * scale,
                           (8, 128, 160, 160), 'bfloat16'))
        for s in range(4):
            rec.stages.append((b, 'net.se', (0.1 + 0.05 * s) * scale, se,
                               'bfloat16'))
    monkeypatch.setattr(profiling, 'RECORDER', rec)
    return {'t0': 0.0, 'seconds': 6.0}


def test_stage_readers_on_hand_made_records(monkeypatch, bench):
    win = _hand_made(monkeypatch)
    # dilated: (1.5 + 3.0) / 2; SE: four stages 0.1-0.25 sum to 0.7 a batch
    assert _reader(bench, 'dilated_ms.infer').read(win) == \
        pytest.approx(2.25)
    assert _reader(bench, 'se_ms.infer').read(win) == \
        pytest.approx((0.7 + 1.4) / 2)
    # 8 SE records of 3 x 8*256*160*160 bf16 elements in 2.1 ms
    bound_s = 8 * 3 * 8 * 256 * 160 * 160 * 2 / 3.35e12
    assert _reader(bench, 'se_roofline').read(win) == \
        pytest.approx(100.0 * bound_s / 2.1e-3)


def test_4stage_forward_opens_its_stages_and_hourglass104_none(monkeypatch):
    """`net.dilated` once and `net.se` once a stack in a 4-stage forward,
    with the stage's input map; none in Hourglass-104's; and on the CPU
    (or outside a loop) no record, whatever the batch."""
    seen = []
    real = Recorder.device_stage

    def spy(self, name, x):
        seen.append((name, tuple(x.shape)))
        return real(self, name, x)

    monkeypatch.setattr(Recorder, 'device_stage', spy)
    before = len(RECORDER.stages) + len(RECORDER.pending)
    monkeypatch.setattr(RECORDER._local, 'batch', 4)     # a sampled batch
    four = PoseNet(ModelConfig(basenet='hourglass4stage', n_stacks=2,
                               compute_dtype='float32')).eval()
    tiny = PoseNet(ModelConfig(n_stacks=1, hg_order=2, dims=(8, 8, 12),
                               modules=(1, 1, 1), cnv_dim=8,
                               compute_dtype='float32')).eval()
    x = torch.rand(1, 64, 64, 3)
    with torch.inference_mode():
        tiny(x)
        assert seen == []
        four(x)
    assert seen == [('net.dilated', (1, 128, 16, 16)),
                    ('net.se', (1, 256, 16, 16)),
                    ('net.se', (1, 256, 16, 16))]
    assert len(RECORDER.stages) + len(RECORDER.pending) == before


def test_device_stage_samples_only_a_loops_cuda_batches():
    """The no-op cases `device_stage` decides on its own: no loop, a CPU
    tensor in a sampled batch; `leave_loop` ends the thread's batch."""
    rec = Recorder()
    x = torch.zeros(1, 2, 4, 4)
    assert rec._local.batch == -1
    assert rec.device_stage('net.se', x) is profiling._NO_STAGE
    for _ in range(rec.STAGE_STRIDE + 1):
        b = rec.new_batch()
    assert b % rec.STAGE_STRIDE == 0
    assert rec.device_stage('net.se', x) is profiling._NO_STAGE
    rec.leave_loop()
    assert rec._local.batch == -1


def test_run_images_leaves_its_thread_outside_a_batch(tmp_path):
    """After `run_images` a forward on its thread belongs to no loop, so
    a later forward there (training, a smoke check) samples nothing."""
    from offsetguided_tpu_torch.config.defaults import DecoderConfig
    from offsetguided_tpu_torch.data import synthetic
    from offsetguided_tpu_torch.data.coco import CocoJson
    from offsetguided_tpu_torch.decoder import PostProcessor
    from offsetguided_tpu_torch.eval.harness import run_images
    img_dir, ann = synthetic.make_hard_dataset(str(tmp_path), n_images=3,
                                               seed=3, ext='npy')
    model = PoseNet(ModelConfig(n_stacks=1, hg_order=2, dims=(8, 8, 12),
                                modules=(1, 1, 1), cnv_dim=8,
                                compute_dtype='float32')).eval()
    pp = PostProcessor(cfg=DecoderConfig(topk=8))
    cfg = EvalConfig(long_edge=64, max_stride=32, batch_size=2,
                     io_workers=1)
    recs = run_images(model.prepare_inference(), pp, CocoJson(ann), img_dir,
                      cfg, all_images=True)
    assert {r['image_id'] for r in recs} == {1, 2, 3}
    assert RECORDER._local.batch == -1


class _DoneEvent:
    """A completed CUDA event's stand-in: `query()` true, 0.5 ms after any
    other."""

    def query(self):
        return True

    def elapsed_time(self, _):
        return 0.5


def test_concurrent_settles_lose_and_repeat_no_stage():
    """Loop threads queueing stages while reader threads settle them (the
    check-then-pop under the recorder's lock): every stage lands in
    `stages` once and each of its two events in the pool once."""
    rec = Recorder()
    dev, n_threads, n_each = 'cuda:0', 8, 400
    rec._pools[dev] = []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def loop(t):
            for i in range(n_each):
                rec.pending.append((t * n_each + i, 'net.se', (1, 2, 3, 4),
                                    'bfloat16', _DoneEvent(), _DoneEvent(),
                                    dev))
                if i % 7 == 0:
                    rec.settle()

        def reader():
            for _ in range(n_each):
                rec.settle()

        threads = ([threading.Thread(target=loop, args=(t,))
                    for t in range(n_threads)]
                   + [threading.Thread(target=reader) for _ in range(4)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    rec.settle()
    assert not rec.pending
    assert sorted(r[0] for r in rec.stages) == list(range(n_threads * n_each))
    assert len(rec._pools[dev]) == 2 * n_threads * n_each
    assert len({id(e) for e in rec._pools[dev]}) == 2 * n_threads * n_each
