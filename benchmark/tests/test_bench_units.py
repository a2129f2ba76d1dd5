"""The yardstick's pieces on hand-made inputs: the scene generator, the
latency percentiles and the window rate, the union of device intervals
and the idle gaps by host span, the kernels' counts, the FLOP count, the
keypoint comparison and the float8 rounding of the control; and the
plain networks: Hourglass-104's seeded weights pinned, the 4-stage net
against the port's."""
from __future__ import annotations

import hashlib
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))

import compare  # noqa: E402
import flops  # noqa: E402
import harness  # noqa: E402
import kernels  # noqa: E402
import loadgen  # noqa: E402
import run  # noqa: E402
import scenes  # noqa: E402
from reference.model import (PlainPoseNet, _q8, make_weights,  # noqa: E402
                             normalize, param_specs)
from trace import Trace, union_seconds  # noqa: E402

COCO = json.loads((HERE / 'configs' / 'hg104-coco.json').read_text())
# a 4-stage configuration names its backbone and depth; the Hourglass-104
# widths do not apply to it
FOUR = {k: v for k, v in COCO.items()
        if k not in ('hg_order', 'dims', 'modules', 'cnv_dim')}
FOUR.update(basenet='hourglass4stage', compute_dtype='float32')
# sha256 over the keys and bytes, in order, of Hourglass-104's seeded COCO
# weights on the CPU at seed 2**31 + 12345, computed before the plain
# networks moved to reference/nets/
HG104_WEIGHTS_SHA256 = ('229398437a09555f1a94c5f069ad71f7'
                        'b0df599e4032dcb01804034b6818a400')
TRAFFIC = {'sizes': [[48, 64], [64, 48], [64, 64]], 'n_scenes': 7}


def test_scenes_repeat_from_the_seed():
    a = scenes.make_scenes(TRAFFIC, 2 ** 31 + 7)
    b = scenes.make_scenes(TRAFFIC, 2 ** 31 + 7)
    assert all(np.array_equal(x[0], y[0]) for x, y in zip(a, b))
    c = scenes.make_scenes(TRAFFIC, 2 ** 31 + 8)
    assert not all(np.array_equal(x[0], y[0]) for x, y in zip(a, c))
    # every seed gives the same sizes, in another order
    assert sorted(x[0].shape for x in a) == sorted(x[0].shape for x in c)


def test_derived_seeds_take_any_whole_number():
    s = {harness.derive(seed, tag) for seed in (0, 2 ** 31 + 5, 2 ** 40)
         for tag in range(1, 5)}
    assert len(s) == 12 and all(0 <= v < 2 ** 63 for v in s)


def test_percentile_on_hand_made_latencies():
    lats = [i / 1000 for i in range(100, 0, -1)]    # 1..100 ms, unsorted
    assert loadgen.percentile(lats, 0.50) == pytest.approx(0.051)
    assert loadgen.percentile(lats, 0.95) == pytest.approx(0.096)
    assert loadgen.percentile(lats, 0.99) == pytest.approx(0.100)
    assert loadgen.percentile([float('inf'), 0.1], 0.95) == float('inf')


def test_window_rate_and_tail_readers():
    rate = harness.metric_reader('infer_img_s').read(
        {'images': 500, 'seconds': 2.0})
    assert rate == 250.0
    p95 = harness.metric_reader('request_p95_ms').read(
        {'latencies': [0.1] * 95 + [0.5] * 5})
    assert p95 == pytest.approx(500.0)
    # the same tail where a cell reports it per layer
    assert harness.metric_reader('request_p95_ms.img_s').read(
        {'latencies': [0.1] * 95 + [0.5] * 5}) == p95
    fill = harness.metric_reader('batcher.fill').read(
        {'requests': 30, 'batches': 4})
    assert fill == 7.5
    # the slices' diagnostic: images done in each 5 s of a 12 s window
    done = [(100.5, 1), (101.0, 4), (106.0, 10), (111.9, 2), (112.5, 7)]
    assert run.rates_by_slice(done, 100.0, 12.0, 5.0) == [1.0, 2.0]


def test_union_of_device_intervals():
    assert union_seconds([(0, 1), (0.5, 2), (3, 4)]) == 3.0
    assert union_seconds([(0, 1), (1, 1.5), (1.2, 1.3)]) == 1.5
    assert union_seconds([]) == 0.0


def _event(cat, name, ts, dur, **args):
    return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
            'tid': 7, 'args': args}


def test_trace_attributes_ops_to_spans_and_labels_idle_gaps():
    ev = [
        _event('user_annotation', 'bench.forward:8x64x64', 0, 100),
        _event('cuda_runtime', 'cudaLaunchKernel', 10, 2, correlation=1),
        _event('cuda_runtime', 'cudaLaunchKernel', 20, 2, correlation=2),
        _event('user_annotation', 'bench.decode:8x64x64', 150, 100),
        _event('cuda_runtime', 'cudaLaunchKernel', 160, 2, correlation=3),
        _event('kernel', 'conv', 30, 40, correlation=1),
        _event('kernel', 'relu', 70, 20, correlation=2),
        _event('kernel', 'peaks_tile_kernel', 200, 10, correlation=3),
    ]
    t = Trace(ev, window_s=300e-6)
    assert t.busy_s() == pytest.approx(70e-6)
    assert t.layer_seconds('bench.forward') == pytest.approx(60e-6)
    assert t.layer_seconds('bench.decode') == pytest.approx(10e-6)
    assert t.n_spans('bench.forward') == 1
    # the gap 90..200 us has its midpoint 145 us outside both spans
    assert t.idle_gaps() == {'host': pytest.approx(110e-6)}
    idle = harness.metric_reader('idle_share.infer').read({'trace': t})
    assert idle == pytest.approx(100 * (1 - 70 / 300))


def test_kernel_counts_on_a_hand_counted_shape():
    cfg = {'keypoints': ['a', 'b'], 'skeleton': [[0, 1]],
           'decoder': {'topk': 4, 'capacity': 8, 'max_poses': 5,
                       'settle_passes': 2}}
    # one image of 16 x 16 input pixels: (2, 4, 4) maps at stride 4
    b, o = kernels.counts('peaks', 1, 16, 16, cfg)
    assert b == 2 * 16 * 4 + 2 * 4 * 12
    assert o == 2 * (7 * 16 * 4 + 16 * 16 * 16 + 4 * 8 * 8)
    b, o = kernels.counts('topk', 1, 16, 16, cfg)
    assert (b, o) == (2 * 64 * 4 + 2 * 4 * 8, 2 * 64)
    b, o = kernels.counts('nms_topk', 1, 16, 16, cfg)
    assert (b, o) == (2 * 16 * 4 + 2 * 4 * 12, 10 * 2 * 16)
    b, o = kernels.counts('grouping', 1, 16, 16, cfg)
    assert b == 1 * 4 * 13 * 4 + 5 * (2 * 6 + 1) * 4 + 4
    assert o == 3 * (16 + 4 * 8 * 4 + 8 * 8 * 2 // 2)
    assert kernels.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert kernels.family('void group_kernel<17>(float const*)') == 'grouping'
    assert kernels.family('nms_topk_kernel(float const*)') == 'nms_topk'
    assert kernels.family('topk_merge_kernel') == 'topk'
    assert kernels.family('sm90_xmma_fprop') is None


def test_flop_count_against_thop():
    """thop gives the reference's Hourglass-104 234.5 GMACs at 512^2; the
    count here is every convolution's multiply-accumulates on the frozen
    plain network, the 1x1 heads' included. The ratio is 1.0007 (234.66
    against 234.5): within what the headline's four figures and thop's
    own per-module rules leave open; widths or depth off by one block
    would move it by a percent or more."""
    macs = flops.forward_flops(COCO, 512, 512) / 2
    ratio = macs / 234.5e9
    print(f'FLOP counter {macs / 1e9:.2f} GMACs at 512^2, thop 234.5: '
          f'ratio {ratio:.4f}')
    assert abs(ratio - 1.0) < 0.005
    assert flops.n_params(COCO) / 1e6 == pytest.approx(187.7, abs=0.05)


def test_mfu_reader_counts_flip_twice():
    cfg = COCO
    f = flops.forward_flops(cfg, 128, 128)
    rec = {'seconds': 1.0, 'images_by_shape': {(128, 128): 10}, 'flip': True,
           'cfg': cfg}
    got = harness.metric_reader('mfu.infer').read(rec)
    assert got == pytest.approx(100 * 2 * 10 * f / kernels.PEAK_BF16_FLOPS)


def test_keypoint_mismatch_on_hand_made_sets():
    a = [np.array([[10.0, 10.0], [20.0, 20.0]]), np.zeros((0, 2))]
    b = [np.array([[10.005, 10.0]]), np.zeros((0, 2))]
    assert compare.mismatch(a, b, 0.01) == pytest.approx(1 / 3)
    assert compare.mismatch(a, a, 0.0) == 0.0
    assert compare.mismatch(a, [np.zeros((0, 2))] * 2, 0.01) == 1.0
    assert compare.mismatch([np.zeros((0, 2))], [np.zeros((0, 2))], 1) == 0.0
    poses = np.zeros((2, 2, 6), np.float32)
    poses[0, 0, :3] = (5, 6, 0.9)
    assert [len(x) for x in compare.from_poses(poses)] == [1, 0]
    recs = [{'keypoints': [5.0, 6.0, 1, 0.0, 0.0, 0]}]
    assert [len(x) for x in compare.from_records(recs, 2)] == [1, 0]


def test_judge_reads_a_missing_number_as_infinite():
    checks = compare.judge({'a': 0.1}, {'a': 0.2, 'b': 0.0})
    assert checks == [('a', 0.1, 0.2), ('b', math.inf, 0.0)]


def test_float8_rounding_of_the_control():
    x = torch.linspace(-3, 3, 1001)
    q = _q8(x)
    rel = ((q - x).abs() / x.abs().clamp(min=1e-3)).max()
    assert 0.01 < float(rel) < 0.07        # 3 mantissa bits: 2^-4
    assert float(_q8(x).abs().max()) == pytest.approx(3.0)


def test_hourglass104_seeded_weights_hash_to_the_pinned_value():
    """The seeded weights of every Hourglass-104 cell are bit for bit those
    the benchmark made before a configuration could name its network:
    same keys, order, draw and scaling."""
    sd = make_weights(COCO, 2 ** 31 + 12345, 'cpu')
    h = hashlib.sha256()
    for k, v in sd.items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    assert h.hexdigest() == HG104_WEIGHTS_SHA256


def test_a_basenet_without_a_plain_network_names_the_missing_file():
    with pytest.raises(FileNotFoundError, match=r'nets/hourglass9\.py'):
        param_specs(dict(FOUR, basenet='hourglass9'))


@pytest.mark.parametrize('n_stacks', [1, 4])
def test_plain_4stage_net_equals_the_port(n_stacks):
    """The plain 4-stage net and the port's `PoseNet` on the same seeded,
    calibrated weights (loaded `strict=True`), 128^2, float32: every map
    of every head and stack, the port unfolded in eval mode and with
    BatchNorm folded as the timed path runs it. Tolerance 1e-4 relative
    L2: both are float32 in different summation orders (the port's convs
    channels_last, its BatchNorm `F.batch_norm` or folded into the
    weights; the reference's NCHW with BatchNorm written out), which
    reads 0.7-2.3e-5 over 1 and 4 stacks; one layer off reads 0.2 or
    more (a dilation 5 as 4: 0.94, LeakyReLU slope 0.02: 0.22, no
    squeeze-and-excitation: 0.63, no feedback: 0.49; at 2 stacks), and
    the float8 control 0.4."""
    from offsetguided_tpu_torch.models import PoseNet

    cfg = dict(FOUR, n_stacks=n_stacks)
    sd = make_weights(cfg, 2 ** 31 + 3, 'cpu')
    g = torch.Generator().manual_seed(9)
    noise = torch.randint(0, 256, (4, 128, 128, 3), generator=g,
                          dtype=torch.uint8)
    PlainPoseNet(cfg, sd).calibrate_(
        normalize(noise, cfg['pixel_mean'], cfg['pixel_std']))
    x = normalize(torch.randint(0, 256, (2, 128, 128, 3), generator=g,
                                dtype=torch.uint8),
                  cfg['pixel_mean'], cfg['pixel_std'])
    ref = PlainPoseNet(cfg, sd)(x)
    port = PoseNet(harness.model_config(cfg))
    port.load_state_dict(sd, strict=True)
    port.eval()
    with torch.no_grad():
        outs = [port(x)]
        outs.append(port.prepare_inference()(x))
    for out in outs:
        for k in ('hmp', 'bg', 'jomp', 'omp', 'scmp'):
            assert len(out[k]) == len(ref[k]) == n_stacks
            for p, r in zip(out[k], ref[k]):
                assert float((p - r).norm() / r.norm()) < 1e-4, k


@pytest.mark.parametrize('n_stacks, gmacs, params_m',
                         [(2, 86.40, 32.45), (4, 154.12, 63.95)])
def test_4stage_flops_and_parameters_equal_the_port_count(n_stacks, gmacs,
                                                          params_m):
    """`mfu.infer`'s count of the plain 4-stage net at 512^2 against
    FlopCounterMode over the port's `PoseNet` on the meta device, and both
    against the figures counted so (the published 4-stack IMHN's 129.0 M
    and 269.9 G include the 5-scale supervision both packages leave
    out)."""
    from torch.utils.flop_counter import FlopCounterMode

    from offsetguided_tpu_torch.models import PoseNet

    cfg = dict(FOUR, n_stacks=n_stacks)
    with torch.device('meta'):
        port = PoseNet(harness.model_config(cfg)).eval()
        with FlopCounterMode(display=False) as counter:
            port(torch.empty(1, 512, 512, 3))
    port_flops = counter.get_total_flops()
    port_params = sum(p.numel() for p in port.parameters())
    plain = flops.forward_flops(cfg, 512, 512)
    assert plain == pytest.approx(port_flops, rel=1e-3)
    assert flops.n_params(cfg) == pytest.approx(port_params, rel=1e-3)
    assert plain / 2e9 == pytest.approx(gmacs, rel=1e-3)
    assert flops.n_params(cfg) / 1e6 == pytest.approx(params_m, rel=1e-3)
