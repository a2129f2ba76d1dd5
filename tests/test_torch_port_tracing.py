"""The port's span recorder (`utils/profiling.py::RECORDER`) on the CPU:
the Batcher's request records and batch stages against the latency a
client measures, `run_images`' spans a dispatched batch, the bounded
rings, the window filter, `run_images`' overlap flags and the
`overlap_share.infer` reader of them, and `profiling.trace`'s export of
the recorder's records beside the profiler's own ranges."""
import importlib.util
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from offsetguided_tpu_torch.cli import serve
from offsetguided_tpu_torch.config.defaults import (DecoderConfig, EvalConfig,
                                                    HeadsConfig, ModelConfig)
from offsetguided_tpu_torch.data import synthetic
from offsetguided_tpu_torch.data.coco import CocoJson
from offsetguided_tpu_torch.data.transforms import make_meta
from offsetguided_tpu_torch.decoder import PostProcessor
from offsetguided_tpu_torch.eval.harness import make_infer_fn, run_images
from offsetguided_tpu_torch.models import PoseNet
from offsetguided_tpu_torch.utils import profiling
from offsetguided_tpu_torch.utils.profiling import (RECORDER, Recorder,
                                                    SpanRecord)

# the suite's worker processes share the host's cores
torch.set_num_threads(2)

BATCH_STAGES = ('serve.stack', 'serve.h2d', 'serve.fetch')
EVAL_STAGES = ('eval.stack', 'eval.h2d', 'infer.forward', 'infer.decode',
               'decode.limbs', 'decode.group', 'eval.fetch', 'eval.records')


def _fake_infer(x):
    n = x.shape[0]
    return (torch.zeros((n, 4, 17, 6)), torch.zeros((n, 4)),
            torch.zeros((n,), dtype=torch.int32))


def _tiny_infer(flip_test=False):
    cfg = ModelConfig(n_stacks=1, hg_order=2, dims=(8, 8, 12),
                      modules=(1, 1, 1), cnv_dim=8, compute_dtype='float32',
                      heads=HeadsConfig())
    torch.manual_seed(0)
    model = PoseNet(cfg).eval().prepare_inference()
    pp = PostProcessor(cfg=DecoderConfig(topk=8, thre_hmp=0.04,
                                         dist_max=40.0, person_thre=0.01))
    return model, pp, make_infer_fn(model, pp, flip_test)


def _clients(batcher, n_threads, n_each, img, meta):
    """Closed-loop clients; returns each call's (start, end) on the
    perf_counter clock."""
    out, lock = [], threading.Lock()

    def worker():
        for _ in range(n_each):
            t0 = time.perf_counter()
            batcher.submit(img, meta)
            t1 = time.perf_counter()
            with lock:
                out.append((t0, t1))

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    return out


def test_batcher_requests_account_for_their_latency():
    """Every request has one record, inside the call its client timed:
    its wait plus its time after the batch's close is the latency the
    client measured, less the client's own overhead and wake-up, which is
    under 1 ms at the median (one wake-up can wait milliseconds for a core
    while the suite's workers share the host). The batch's stages lie
    between the close and its answers."""
    b = serve.Batcher(_fake_infer, 2, 20.0, 'cpu')
    img, meta = np.zeros((8, 8, 3), np.uint8), make_meta(8, 8)
    try:
        _clients(b, 2, 1, img, meta)                # first calls, not read
        t_begin = time.perf_counter()
        calls = _clients(b, 2, 6, img, meta)
    finally:
        b.close()
    w = RECORDER.window(t_begin, time.perf_counter())
    assert len(calls) == 12 and len(w.requests) == 12
    assert len({r.request for r in w.requests}) == 12
    matched, rest = set(), []
    for t0, t1 in calls:
        # a call's record: the first submit stamped after the call began
        r = min((r for r in w.requests if t0 <= r.t_submit <= t1),
                key=lambda r: r.t_submit - t0)
        matched.add(r.request)
        assert r.t_submit <= r.t_taken <= r.t_answered <= t1
        wait, served = r.t_taken - r.t_submit, r.t_answered - r.t_taken
        rest.append((t1 - t0) - (wait + served))
    assert len(matched) == 12
    assert min(rest) >= 0 and sorted(rest)[len(rest) // 2] < 1e-3
    by_batch = {}
    for s in w.spans:
        by_batch.setdefault(s.batch, {})[s.name] = s
    assert set(by_batch) == {r.batch for r in w.requests}
    for batch, spans in by_batch.items():
        reqs = [r for r in w.requests if r.batch == batch]
        taken = reqs[0].t_taken
        assert all(r.t_taken == taken for r in reqs)
        first = min(r.t_answered for r in reqs)
        last = max(r.t_answered for r in reqs)
        assert spans['serve.collect'].t1 == taken
        assert spans['serve.collect'].t0 >= min(r.t_submit for r in reqs)
        for name in BATCH_STAGES:
            assert taken <= spans[name].t0 <= spans[name].t1 <= first
        assert spans['serve.stack'].t1 <= spans['serve.h2d'].t0
        assert spans['serve.h2d'].t1 <= spans['serve.fetch'].t0
        answer = spans['serve.answer']
        assert spans['serve.fetch'].t1 <= answer.t0 <= first
        assert last <= answer.t1
    # the CPU has no events: no gap is recorded
    assert w.gaps == []


def test_run_images_records_one_set_of_spans_a_batch(tmp_path):
    img_dir, ann = synthetic.make_hard_dataset(str(tmp_path), n_images=5,
                                               seed=3, ext='npy')
    model, pp, _ = _tiny_infer()
    cfg = EvalConfig(long_edge=64, fixed_height=True, max_stride=32,
                     width_bucket=64, flip_test=True, batch_size=2,
                     io_workers=2)
    t_begin = time.perf_counter()
    recs = run_images(model, pp, CocoJson(ann), img_dir, cfg,
                      all_images=True)
    w = RECORDER.window(t_begin, time.perf_counter())
    assert {r['image_id'] for r in recs} == {1, 2, 3, 4, 5}
    dispatched = {b: st for b, st in w.batches.items() if 'eval.h2d' in st}
    # five images in batches of two, with a flush at each shape change
    assert 3 <= len(dispatched) <= 5
    assert sum(1 for s in w.spans if s.name == 'eval.io_wait') == 5
    by_batch = {}
    for s in w.spans:
        by_batch.setdefault(s.batch, []).append(s)
    for batch in dispatched:
        spans = by_batch[batch]
        names = [s.name for s in spans]
        for name in EVAL_STAGES + ('decode.merge',):
            assert names.count(name) == 1, (name, names)
        one = {s.name: s for s in spans}
        fwd, dec = one['infer.forward'], one['infer.decode']
        assert one['eval.h2d'].t1 <= fwd.t0 <= fwd.t1 <= dec.t0
        for name in ('decode.merge', 'decode.limbs', 'decode.group'):
            assert dec.t0 <= one[name].t0 <= one[name].t1 <= dec.t1
        assert dec.t1 <= one['eval.fetch'].t0 <= one['eval.records'].t0
    assert not w.gaps


def test_run_images_records_one_overlap_flag_a_batch(tmp_path):
    """On the CPU `run_images` records one overlap flag a dispatched
    batch, each False: nothing runs behind the host there."""
    img_dir, ann = synthetic.make_hard_dataset(str(tmp_path), n_images=5,
                                               seed=4, ext='npy')
    model, pp, _ = _tiny_infer()
    cfg = EvalConfig(long_edge=64, fixed_height=True, max_stride=32,
                     width_bucket=64, batch_size=2, io_workers=2)
    t_begin = time.perf_counter()
    run_images(model, pp, CocoJson(ann), img_dir, cfg, all_images=True)
    w = RECORDER.window(t_begin, time.perf_counter())
    dispatched = sorted(b for b, st in w.batches.items() if 'eval.h2d' in st)
    assert len(dispatched) >= 3
    assert sorted(o.batch for o in w.overlaps) == dispatched
    assert not any(o.in_flight for o in w.overlaps)


def overlap_reader():
    path = (Path(__file__).resolve().parents[1] / 'benchmark' / 'metrics'
            / 'overlap_share.infer.py')
    spec = importlib.util.spec_from_file_location('overlap_share', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_overlap_share_reader_counts_the_windows_batches(monkeypatch):
    """`overlap_share.infer` on a hand-built recorder: the share of the
    flags True among the batches that start in the window."""
    rec = Recorder()
    # batch b starts at second b; batches 0-1 and 8-9 lie outside [2, 8)
    for b in range(10):
        rec.add_span('eval.stack', b, b + 0.5, b)
        rec.overlaps.append((b, b % 3 != 0))
    monkeypatch.setattr(profiling, 'RECORDER', rec)
    # batches 2-7: 3 and 6 were enqueued with nothing in flight
    share = overlap_reader().read({'t0': 2.0, 'seconds': 6.0})
    assert share == pytest.approx(100.0 * 4 / 6)


def test_overlap_share_reader_gives_none_without_records(monkeypatch):
    rec = Recorder()
    rec.add_span('serve.stack', 0.0, 0.5, 0)        # a batch, no flags
    monkeypatch.setattr(profiling, 'RECORDER', rec)
    reader = overlap_reader()
    assert reader.read({'t0': 0.0, 'seconds': 1.0}) is None
    assert reader.read({'t0': 5.0, 'seconds': 1.0}) is None


def test_rings_stay_bounded():
    rec = Recorder(capacity=16)
    for i in range(100):
        rec.stop(rec.start('s'), i)
        rec.requests.append((i, i, 0.0, 1.0, 2.0))
        rec.gaps.append((i, i - 1, 0.5))
        rec.overlaps.append((i, True))
    assert len(rec.spans) == len(rec.requests) == len(rec.gaps) == 16
    assert len(rec.overlaps) == 16
    assert [s[3] for s in rec.spans] == list(range(84, 100))
    assert [r[0] for r in rec.requests] == list(range(84, 100))


def test_concurrent_records_are_not_lost():
    """Threads that record at once, with the interpreter switching threads
    every microsecond: no span is lost and no request number repeats."""
    rec, n_threads, n_each = Recorder(), 16, 500
    ids, lock = [], threading.Lock()

    def worker():
        mine = []
        rec.new_batch()
        for _ in range(n_each):
            rec.stop(rec.start('s'))
            mine.append(rec.new_request())
        with lock:
            ids.extend(mine)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(rec.spans) == n_threads * n_each
    assert len(set(ids)) == n_threads * n_each
    # each thread's spans carry its own batch
    assert len({(s[3], s[4]) for s in rec.spans}) == n_threads


def test_window_drops_records_outside_it():
    rec = Recorder()
    # batch b starts at second b, runs two stages of 0.25 s
    for b in range(6):
        rec.add_span('x.first', b, b + 0.25, b)
        rec.add_span('x.second', b + 0.25, b + 0.5, b)
        rec.requests.append((100 + b, b, b - 0.5, b, b + 0.5))
        rec.gaps.append((b, b - 1, 1.5))
    rec.add_span('infer.forward', 2.5, 2.6, -1)     # outside any loop
    w = rec.window(2.0, 5.0)
    assert sorted(w.batches) == [2, 3, 4]
    assert w.batches[3] == {'x.first': 0.25, 'x.second': 0.25}
    assert [r.request for r in w.requests] == [102, 103, 104]
    # the gap into batch 2 comes from batch 1, outside the window
    assert [(g.batch, g.previous) for g in w.gaps] == [(3, 2), (4, 3)]
    assert all(s.batch in (2, 3, 4) for s in w.spans) and len(w.spans) == 6
    empty = rec.window(10.0, 20.0)
    assert not (empty.batches or empty.spans or empty.requests or empty.gaps)


def test_trace_holds_the_mirrored_ranges_and_the_ring(tmp_path):
    """Inside `profiling.trace`: a Batcher run with client threads, then
    three infer calls on the profiled thread. The profiler's own
    `infer.forward` ranges of those calls lie within 0.5 ms of the ring's
    copies mapped through the anchor; the Batcher thread's spans and the
    clients' waits are in the trace from the ring."""
    _, _, infer = _tiny_infer()
    x = torch.zeros((2, 64, 64, 3), dtype=torch.uint8)
    infer(x)
    b = serve.Batcher(infer, 2, 20.0, 'cpu')
    me = threading.get_ident()
    try:
        with profiling.trace(str(tmp_path)):
            t_begin = time.perf_counter()
            calls = _clients(b, 2, 2, np.zeros((64, 64, 3), np.uint8),
                             make_meta(64, 64))
            for _ in range(3):
                infer(x)
    finally:
        b.close()
    doc = json.loads((tmp_path / 'trace.json').read_text())
    events = doc['traceEvents']
    anchor = doc['programClockAnchor']
    base = doc.get('baseTimeNanoseconds', 0)

    def us(t):
        return (anchor['time_ns'] + t * 1e9 - anchor['perf_counter_ns']
                - base) / 1e3

    ring = [SpanRecord._make(s) for s in RECORDER.spans]
    ring = [s for s in ring if s.name == 'infer.forward' and s.thread == me
            and s.t0 >= t_begin]
    mirrored = sorted((e['ts'], e['ts'] + e['dur']) for e in events
                      if e.get('cat') == 'user_annotation'
                      and e['name'] == 'infer.forward')
    assert len(ring) == len(mirrored) == 3
    for (m0, m1), s in zip(mirrored, ring):
        assert abs(m0 - us(s.t0)) < 500 and abs(m1 - us(s.t1)) < 500
    spans = [e for e in events if e.get('cat') == 'program_span']
    names = {e['name'] for e in spans}
    assert {'serve.collect', 'serve.stack', 'serve.h2d', 'infer.forward',
            'infer.decode', 'decode.limbs', 'decode.group', 'serve.fetch',
            'serve.answer'} <= names
    waits = [e for e in events if e.get('cat') == 'program_request']
    assert len(calls) == 4
    assert sorted(e['ph'] for e in waits) == ['b'] * 4 + ['e'] * 4
    for e in waits:
        if e['ph'] == 'b':
            t = (e['ts'] - us(0.0)) * 1e-6
            assert any(abs(t - t0) < 1e-3 for t0, _ in calls)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.gpu
def test_device_gaps_on_the_card(card):
    """On the card a loop records the gap into every fourth batch, from
    the previous batch's last launch to this batch's first copy: at least
    the host's sleep between them. A sampled batch that fails after
    `begin` is dropped at the next read."""
    rec = Recorder()
    gaps = profiling.DeviceGaps(card, rec)
    x = torch.ones((1 << 20,), device=card)
    for b in range(17):
        gaps.begin(b)
        x.mul_(1.0)
        if b == 12:                         # fails before its end
            continue
        gaps.end(b)
        x.cpu()                             # the fetch: waits for the batch
        gaps.read(b)
        time.sleep(0.002)                   # host work between batches
    assert [(g[0], g[1]) for g in rec.gaps] == [(4, 3), (8, 7), (16, 15)]
    assert all(g[2] >= 1.5 for g in rec.gaps)
    assert not gaps._open
