"""The port's HTTP pose server (`cli/serve.py`) on the CPU: the six cases
of tests/test_serve.py (health, one request, concurrent micro-batching, a
bad image, an empty body, metrics), the batcher's metrics record and
`poses_to_json` against the JAX package's, and the served JSON of one PNG
body equal to what the JAX package's `build_infer` + `Batcher` +
`poses_to_json` give with the same weights (a reference-format `.pth`
both servers load with `--torch-checkpoint`), upsampled and
`--lowres-decode`. One JAX compile per decode mode."""
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offsetguided_tpu.cli import serve as jserve
from offsetguided_tpu.config.defaults import ModelConfig as JModelConfig
from offsetguided_tpu.eval.harness import preprocess_eval as jpreprocess
from offsetguided_tpu.models import PoseNet as JPoseNet
from offsetguided_tpu_torch.cli import serve
from offsetguided_tpu_torch.data import codec
from offsetguided_tpu_torch.data.transforms import make_meta
from offsetguided_tpu_torch.models import state_dict_from_jax
from offsetguided_tpu_torch.models.checkpoint import load_reference_checkpoint

FLAGS = ['--debug-tiny-model', '--long-edge', '128', '--batch-size', '2',
         '--batch-window-ms', '30', '--port', '0',
         '--request-timeout-s', '300']
MODES = {'upsampled': [], 'lowres': ['--lowres-decode']}


def tamed_variables(jcfg, seed=2):
    """JAX variables of `jcfg` with seeded He-scaled kernels and BatchNorm
    variances >= 0.5 (tests/test_torch_port_model.py's), so the tiny
    network's heatmaps have peaks and grouping has work."""
    shapes = jax.eval_shape(
        lambda: JPoseNet(jcfg).init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 32, 32, 3)), train=False))
    rng = np.random.RandomState(seed)

    def draw(path, x):
        name = jax.tree_util.keystr(path)
        if len(x.shape) == 4:
            return (rng.randn(*x.shape) / np.sqrt(np.prod(x.shape[:3]))
                    ).astype(np.float32)
        if name.endswith("['var']"):
            return (np.abs(rng.randn(*x.shape)) + 0.5).astype(np.float32)
        return (0.5 * rng.randn(*x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope='module')
def pth(tmp_path_factory):
    """The serve tiny model's weights as a reference `.pth`."""
    args = serve.cli(FLAGS)
    jcfg = JModelConfig(n_stacks=1, hg_order=2, dims=(8, 8, 12),
                        modules=(1, 1, 1), cnv_dim=8, compute_dtype='float32')
    sd = state_dict_from_jax(tamed_variables(jcfg), serve.model_config(args))
    path = tmp_path_factory.mktemp('weights') / 'posenet.pth'
    torch.save({'model_state_dict': sd}, str(path))
    return str(path)


def start(argv):
    args = serve.cli(argv)
    cfg = serve.model_config(args)
    infer, skeleton, eval_cfg, _ = serve.build_infer(
        args, cfg, serve.load_weights(args, cfg), 'cpu')
    srv = serve.make_server(args, infer, skeleton, eval_cfg)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    host, port = srv.server_address[:2]
    return srv, f'http://{host}:{port}'


@pytest.fixture(scope='module')
def servers(pth):
    """The port's server in each decode mode, on the CPU."""
    running = {m: start(FLAGS + extra + ['--torch-checkpoint', pth,
                                         '--device', 'cpu'])
               for m, extra in MODES.items()}
    yield {m: url for m, (_, url) in running.items()}
    for srv, _ in running.values():
        srv.shutdown()
        srv.server_close()


@pytest.fixture(scope='module')
def server_url(servers):
    return servers['upsampled']


@pytest.fixture(scope='module')
def jax_infer(pth):
    """JAX's build_infer per decode mode, built on first use (one compile
    each, shared by the tests of that mode)."""
    cache = {}

    def get(mode):
        if mode not in cache:
            cache[mode] = jserve.build_infer(jserve.cli(
                FLAGS + MODES[mode] + ['--torch-checkpoint', pth]))
        return cache[mode]
    return get


def _jpeg(rng, h=97, w=153):
    return codec.encode_jpeg((rng.rand(h, w, 3) * 255).astype(np.uint8))


def _post(url, body):
    req = urllib.request.Request(url + '/v1/poses', data=body,
                                 headers={'Content-Type': 'image/jpeg'})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_healthz(server_url):
    status, payload = _get(server_url, '/healthz')
    assert status == 200
    assert payload == {'status': 'ok', 'device': 'cpu', 'long_edge': 128,
                       'batch_size': 2, 'flip_test': False,
                       'n_keypoints': 17}


def test_single_pose_request(server_url, rng):
    status, payload = _post(server_url, _jpeg(rng))
    assert status == 200
    assert payload['image'] == {'width': 153, 'height': 97}
    assert payload['poses']               # the tamed weights give poses
    for pose in payload['poses']:
        assert len(pose['keypoints']) == 17
        assert all(len(k) == 3 for k in pose['keypoints'])
        assert np.isfinite(pose['score'])
    assert payload['latency_ms'] > 0


def test_concurrent_requests_microbatch(server_url, rng):
    """More concurrent requests than the batch capacity: every request gets
    its own answer with its own image's dimensions."""
    bodies = [_jpeg(rng, h=90 + i, w=140 + i) for i in range(5)]
    results = [None] * len(bodies)

    def go(i):
        results[i] = _post(server_url, bodies[i])

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for i, res in enumerate(results):
        assert res is not None, f'request {i} never finished'
        status, payload = res
        assert status == 200
        assert payload['image'] == {'width': 140 + i, 'height': 90 + i}


@pytest.mark.parametrize('body,code', [(b'not an image', 400), (b'', 400)])
def test_bad_requests_rejected(server_url, body, code):
    """An undecodable and an empty body: 400."""
    req = urllib.request.Request(server_url + '/v1/poses', data=body,
                                 headers={'Content-Type': 'image/jpeg'})
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=60)
    assert exc.value.code == code


def test_unknown_paths_404(server_url):
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(server_url + '/nope', timeout=60)
    assert exc.value.code == 404
    req = urllib.request.Request(server_url + '/v1/nope', data=b'x')
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=60)
    assert exc.value.code == 404


def test_metrics_endpoint(server_url, rng):
    _post(server_url, _jpeg(rng))
    status, m = _get(server_url, '/metrics')
    assert status == 200
    assert m['requests'] >= 1
    assert m['batches'] >= 1
    assert m['errors'] == 0
    assert m['batch_capacity'] == 2
    assert 0 < m['mean_batch_fill'] <= 2
    assert m['device_batch_latency_ms']['p50'] > 0
    assert m['queue_depth'] == 0


# ----------------------------------------------------- batcher metrics

def _fake_infer(batch):
    n = batch.shape[0]
    return (np.zeros((n, 4, 17, 6), np.float32), np.zeros((n, 4)),
            np.zeros((n,), np.int32))


def _torch_fake_infer(batch):
    return tuple(torch.from_numpy(np.asarray(x)) for x in _fake_infer(batch))


def test_batcher_metrics_record_equals_jax():
    """The same counts, fills and latency ring give the same record: keys,
    rounding and the percentile element min(int(q n), n - 1)."""
    port = serve.Batcher(_torch_fake_infer, 8, 1.0, 'cpu')
    ref = jserve.Batcher(_fake_infer, 8, 1.0)
    try:
        assert port.metrics() == ref.metrics()      # before any batch
        lats = list(np.random.RandomState(0).rand(37) * 0.2)
        for b in (port, ref):
            b.n_requests, b.n_batches, b.n_errors = 61, 37, 2
            b._fill_sum = 61
            b._lat_ring = list(lats)
        got, want = port.metrics(), ref.metrics()
        assert got == want
        assert set(got) == {'requests', 'batches', 'errors', 'batch_capacity',
                            'mean_batch_fill', 'device_batch_latency_ms',
                            'queue_depth'}
        s = sorted(lats)
        assert got['device_batch_latency_ms']['p90'] == round(
            s[int(0.9 * 37)] * 1e3, 1)
    finally:
        port.close()


def test_batcher_metrics_after_batches():
    """Two concurrent requests fill one batch of 2, a third runs alone:
    3 requests, 2 batches, mean fill 1.5, three latencies."""
    b = serve.Batcher(_torch_fake_infer, 2, 500.0, 'cpu')
    img = np.zeros((8, 8, 3), np.uint8)
    meta = make_meta(8, 8)
    try:
        ts = [threading.Thread(target=b.submit, args=(img, meta))
              for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        b.submit(img, meta)
        m = b.metrics()
    finally:
        b.close()
    assert (m['requests'], m['batches'], m['errors']) == (3, 2, 0)
    assert m['batch_capacity'] == 2 and m['mean_batch_fill'] == 1.5
    lat = m['device_batch_latency_ms']
    assert lat['p50'] is not None and lat['p50'] <= lat['p90'] <= lat['p99']


def test_poses_to_json_equals_jax():
    rng = np.random.RandomState(3)
    poses = (rng.randn(6, 17, 6) * 50).astype(np.float32)
    poses[2] = 0.0                                  # an empty row is dropped
    poses[4, :, :3] = 0.0
    assert serve.poses_to_json(poses) == jserve.poses_to_json(poses)
    assert len(serve.poses_to_json(poses)) == 4


# ------------------------------------------------------- JAX parity

def _parity_png():
    """A 96 x 128 image: the long edge is already 128, so both packages'
    preprocessing only pads."""
    rng = np.random.RandomState(5)
    return codec.encode_png((rng.rand(96, 128, 3) * 255).astype(np.uint8))


@pytest.mark.parametrize('mode', sorted(MODES))
def test_served_json_equals_jax(servers, jax_infer, mode):
    body = _parity_png()
    infer, _, ecfg = jax_infer(mode)
    img = codec.decode(body)
    x, _, meta = jpreprocess(img, np.zeros((0, 17, 4), np.float32), ecfg, 17,
                             normalize=False)
    batcher = jserve.Batcher(infer, ecfg.batch_size, 30.0)
    want = jserve.poses_to_json(batcher.submit(x, meta, timeout=600))
    status, payload = _post(servers[mode], body)
    assert status == 200
    assert payload['image'] == {'width': 128, 'height': 96}
    assert payload['poses'] == want
    assert len(want) > 3                          # real poses, not dummies


def test_lowres_build_infer_equals_jax(pth, jax_infer):
    """`build_infer` with `lowres_decode` decodes at stride resolution as
    the JAX package's does: the same counts and poses for one batch."""
    args = serve.cli(FLAGS + ['--lowres-decode'])
    infer, _, _, _ = serve.build_infer(
        args, serve.model_config(args),
        load_reference_checkpoint(pth), 'cpu')
    assert not infer.postprocessor.cfg.upsampled_decode
    jinfer, _, _ = jax_infer('lowres')
    rng = np.random.RandomState(6)
    imgs = rng.randint(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    p, _, c = infer(torch.from_numpy(imgs))
    jp, _, jc = (np.asarray(t) for t in jinfer(jnp.asarray(imgs)))
    assert np.array_equal(c.numpy(), jc) and c.sum() > 0
    for i in range(2):
        n = int(jc[i])
        np.testing.assert_allclose(p.numpy()[i, :n, :, :3], jp[i, :n, :, :3],
                                   rtol=0, atol=1e-3)
