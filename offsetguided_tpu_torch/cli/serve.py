#!/usr/bin/env python
"""Batched HTTP pose-estimation server.

Port of the JAX package's `cli/serve.py`, with its 19 flags and defaults
plus `--device` (the card unless told otherwise). `build_infer` makes the
model (random seeded weights, BatchNorm calibrated at `--long-edge`; the
port's own training checkpoint with `--checkpoint`; a reference `.pth`
with `--torch-checkpoint`), the decoder (`--lowres-decode` for the
stride-resolution decode) and the batched infer function on one device.
`Batcher` collects up to `--batch-size` requests within
`--batch-window-ms`, zero-pads them to the one batch shape, runs one
infer and answers each request with its poses in original image
coordinates; it records each batch's stages, each request's queue wait
and the device gap between batches in `utils/profiling.RECORDER`.
`make_server` puts a thread-per-connection HTTP server in front of it;
request bodies are decoded by the port's own JPEG / PNG codec
(`data/codec.py`), which gives cv2.imdecode's pixels without OpenCV.

Endpoints:
  GET  /healthz    -> {"status": "ok", "device": "cuda" | "cpu", ...}
  GET  /metrics    -> the batcher's counters and device-batch latencies
  POST /v1/poses   (body: JPEG/PNG bytes) ->
      {"image": {"width": W, "height": H},
       "poses": [{"keypoints": [[x, y, score] * J], "score": s}, ...],
       "latency_ms": t}

    python -m offsetguided_tpu_torch.cli.serve [--port 8080] [--flip-test]

`--dataset crowdpose` serves the CrowdPose configuration: heads and poses
of 14 keypoints.
"""
from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..config.defaults import (DecoderConfig, EvalConfig, HeadsConfig,
                               ModelConfig, SkeletonConfig)
from ..data import codec
from ..data import transforms as T
from ..decoder import PostProcessor
from ..device import resolve_device
from ..eval.harness import make_infer_fn, preprocess_eval
from ..models import PoseNet, random_posenet
from ..utils.profiling import RECORDER, DeviceGaps


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--checkpoint', default=None,
                   help="the port's training checkpoint (posenet_NNN.pt)")
    p.add_argument('--torch-checkpoint', default=None,
                   help='reference .pth checkpoint to serve')
    p.add_argument('--dataset', default='coco', choices=['coco', 'crowdpose'])
    p.add_argument('--long-edge', type=int, default=640)
    p.add_argument('--flip-test', action='store_true')
    p.add_argument('--batch-size', type=int, default=8,
                   help='micro-batch capacity (the one batch shape)')
    p.add_argument('--batch-window-ms', type=float, default=5.0,
                   help='max time to wait collecting a micro-batch')
    p.add_argument('--topk', type=int, default=32)
    p.add_argument('--thre-hmp', type=float, default=0.04)
    p.add_argument('--dist-max', type=float, default=40.0)
    p.add_argument('--person-thre', type=float, default=0.06)
    p.add_argument('--lowres-decode', action='store_true')
    p.add_argument('--min-len', type=float, default=0.5)
    p.add_argument('--sort-dim', type=int, default=2, choices=[2, 4])
    p.add_argument('--resize-mode', default='bicubic',
                   choices=['bicubic', 'bilinear'])
    p.add_argument('--host', default='127.0.0.1')
    p.add_argument('--port', type=int, default=8080)
    p.add_argument('--request-timeout-s', type=float, default=60.0,
                   help='max seconds a request waits for its micro-batch')
    p.add_argument('--debug-tiny-model', action='store_true',
                   help='narrow random-weight backbone (CI / smoke use)')
    p.add_argument('--device', default=None,
                   help='torch device (default: the card)')
    return p.parse_args(argv)


def model_config(args, skeleton: SkeletonConfig = SkeletonConfig()
                 ) -> ModelConfig:
    """The JAX server's model: Hourglass-104 in bf16, or with
    `--debug-tiny-model` its narrow fp32 network; heads of `skeleton`."""
    heads = HeadsConfig(n_keypoints=skeleton.n_keypoints,
                        n_limbs=skeleton.n_limbs)
    if args.debug_tiny_model:
        return ModelConfig(n_stacks=1, hg_order=2, dims=(8, 8, 12),
                           modules=(1, 1, 1), cnv_dim=8,
                           compute_dtype='float32', heads=heads)
    return ModelConfig(heads=heads)


def load_weights(args, model_cfg: ModelConfig) -> Optional[dict]:
    """The state dict of `--torch-checkpoint` or `--checkpoint`, or None
    (random seeded weights). Either is loaded leaf by leaf into the
    trainer's fresh initialization (seed 0), as the JAX package loads it:
    a reference `.pth` (a full network or a bare backbone) through
    `load_reference_into`, whose unmatched entries are printed and keep
    the fresh values; the port's training checkpoint through
    `load_checkpoint` without its optimizer state."""
    from ..models.checkpoint import load_checkpoint, load_reference_into
    from ..models.network import init_reference_
    if not (args.torch_checkpoint or args.checkpoint):
        return None
    model = init_reference_(PoseNet(model_cfg),
                            torch.Generator().manual_seed(0))
    if args.torch_checkpoint:
        unmatched = load_reference_into(model, args.torch_checkpoint)
        if unmatched:
            print(f'[convert] {len(unmatched)} unmatched entries',
                  unmatched[:5])
    else:
        load_checkpoint(args.checkpoint, model, drop_optimizer=True)
    return model.state_dict()


def build_infer(args, model_cfg: Optional[ModelConfig] = None,
                state_dict: Optional[dict] = None, device=None,
                seed: int = 0):
    """-> (infer, skeleton, eval_cfg, model) from `cli()`'s arguments;
    `model_cfg` defaults to `model_config` of `--dataset`'s skeleton.
    Without a `state_dict` the weights are `random_posenet(seed)`,
    calibrated at `args.long_edge`."""
    dev = resolve_device(device)
    skeleton = SkeletonConfig.for_dataset(args.dataset)
    if model_cfg is None:
        model_cfg = model_config(args, skeleton)
    if state_dict is not None:
        model = PoseNet(model_cfg)
        model.load_state_dict(state_dict, strict=True)
    else:
        model = random_posenet(model_cfg, seed, device=dev,
                               calib_size=args.long_edge)
    model = model.to(dev).prepare_inference()
    pp = PostProcessor(skeleton=skeleton, cfg=DecoderConfig(
        topk=args.topk, thre_hmp=args.thre_hmp, dist_max=args.dist_max,
        person_thre=args.person_thre, min_len=args.min_len,
        sort_dim=args.sort_dim, resize_mode=args.resize_mode,
        upsampled_decode=not args.lowres_decode))
    eval_cfg = EvalConfig(long_edge=args.long_edge, flip_test=args.flip_test,
                          batch_size=args.batch_size)
    infer = make_infer_fn(model, pp, args.flip_test)
    return infer, skeleton, eval_cfg, model


class Batcher:
    """Cross-request micro-batching onto one fixed batch shape.

    Requests enqueue (uint8 image, meta); one dispatcher thread collects up
    to `batch_size` of them within `window_ms`, zero-pads to the batch
    shape, runs `infer` once on `device`, and hands each request its
    inverse-transformed poses. `close()` stops the thread.

    Each batch records in `RECORDER` its spans `serve.collect` (from the
    first request's arrival to the batch's close), `serve.stack`,
    `serve.h2d`, `serve.fetch` (both copies back) and `serve.answer` (the
    inverses and the hand-overs), with `infer.*` between h2d and fetch;
    each answered request its submit, its batch's close and its answer;
    on a CUDA device the idle gap since the previous batch."""

    def __init__(self, infer, batch_size: int, window_ms: float, device):
        self._infer = infer
        self._bs = batch_size
        self._window = window_ms / 1e3
        self._device = torch.device(device)
        self._q: queue.Queue = queue.Queue()
        # observability (read under _mlock by /metrics)
        self._mlock = threading.Lock()
        self.n_requests = 0
        self.n_batches = 0
        self.n_errors = 0
        self._fill_sum = 0          # images per dispatched batch
        self._lat_ring = []         # last 512 device-batch latencies (s)
        self._gaps = DeviceGaps(self._device)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def metrics(self) -> dict:
        """The JAX server's record: counts, capacity, mean fill, and the
        device-batch latency percentiles (ms, 0.1 ms) over the last 512
        batches, element min(int(q n), n - 1) of the sorted latencies."""
        with self._mlock:
            lats = sorted(self._lat_ring)
            n = len(lats)

            def pct(q):
                return round(lats[min(int(q * n), n - 1)] * 1e3, 1) if n \
                    else None

            return {
                'requests': self.n_requests,
                'batches': self.n_batches,
                'errors': self.n_errors,
                'batch_capacity': self._bs,
                'mean_batch_fill': (round(self._fill_sum / self.n_batches, 2)
                                    if self.n_batches else None),
                'device_batch_latency_ms': {
                    'p50': pct(0.50), 'p90': pct(0.90), 'p99': pct(0.99)},
                'queue_depth': self._q.qsize(),
            }

    def submit(self, image: np.ndarray, meta, timeout: float = 60.0):
        """Blocks until this request's batch returns; poses in original
        image coordinates, shape (M, J, 6)."""
        ev = threading.Event()
        slot = {}
        self._q.put((image, meta, ev, slot, RECORDER.new_request(),
                     time.perf_counter()))
        if not ev.wait(timeout):
            raise TimeoutError('inference timed out')
        if 'error' in slot:
            raise slot['error']
        return slot['poses']

    def close(self, timeout: float = 10.0) -> None:
        self._q.put(None)
        self._thread.join(timeout)

    def _loop(self):
        while True:
            first = self._q.get()
            if first is None:
                return
            t_first = time.perf_counter()
            seq = RECORDER.new_batch()
            batch = [first]
            deadline = time.monotonic() + self._window
            stop = False
            while len(batch) < self._bs:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    item = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if item is None:
                    stop = True
                    break
                batch.append(item)
            t_taken = time.perf_counter()
            RECORDER.add_span('serve.collect', t_first, t_taken, seq)
            self._run(batch, seq, t_taken)
            if stop:
                return

    def _run(self, batch, seq: int, t_taken: float):
        rec = RECORDER
        stage = rec.start('serve.stack')
        imgs = [b[0] for b in batch]
        while len(imgs) < self._bs:
            imgs.append(np.zeros_like(imgs[0]))
        t0 = time.monotonic()
        err = 0
        try:
            stacked = np.stack(imgs)
            rec.stop(stage, seq)
            self._gaps.begin(seq)
            stage = rec.start('serve.h2d')
            x = torch.from_numpy(stacked).to(self._device)
            rec.stop(stage, seq)
            poses, _, counts = self._infer(x)
            self._gaps.end(seq)
            stage = rec.start('serve.fetch')
            poses = poses.cpu().numpy()
            counts = counts.cpu().numpy()
            rec.stop(stage, seq)
            self._gaps.read(seq)
            stage = rec.start('serve.answer')
            # each answer's RequestRecord, stamped before its waiter wakes
            answered, now = rec.requests.append, time.perf_counter
            for i, (_, meta, ev, slot, rid, t_submit) in enumerate(batch):
                slot['poses'] = T.annotations_inverse(
                    poses[i][:int(counts[i])], meta)
                answered((rid, seq, t_submit, t_taken, now()))
                ev.set()
            rec.stop(stage, seq)
        except Exception as e:  # every waiter of the batch sees the error
            for _, _, ev, slot, _, _ in batch:
                slot['error'] = e
                ev.set()
            err = len(batch)
        with self._mlock:
            self.n_requests += len(batch)
            self.n_batches += 1
            self.n_errors += err
            self._fill_sum += len(batch)
            self._lat_ring.append(time.monotonic() - t0)
            if len(self._lat_ring) > 512:
                del self._lat_ring[0]


def poses_to_json(poses: np.ndarray) -> list:
    """(M, J, >=3) poses -> the JSON list of people with any keypoint:
    [x, y, score] per joint (2 and 4 decimals), the mean joint score."""
    out = []
    for person in np.asarray(poses):
        if not np.any(person[:, :3]):
            continue
        kps = [[round(float(x), 2), round(float(y), 2), round(float(v), 4)]
               for x, y, v in person[:, :3]]
        out.append({'keypoints': kps,
                    'score': round(float(person[:, 2].mean()), 4)})
    return out


def make_server(args, infer, skeleton, eval_cfg):
    """ThreadingHTTPServer wired to a `Batcher` (`server.batcher`);
    returned unstarted so callers can bind port 0 and read
    `server.server_address`. `server_close()` also stops the batcher."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    device = next(infer.model.parameters()).device
    batcher = Batcher(infer, eval_cfg.batch_size, args.batch_window_ms,
                      device)
    n_kp = skeleton.n_keypoints

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):      # quiet per-request stderr spam
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == '/healthz':
                self._json(200, {
                    'status': 'ok',
                    'device': device.type,
                    'long_edge': eval_cfg.long_edge,
                    'batch_size': eval_cfg.batch_size,
                    'flip_test': eval_cfg.flip_test,
                    'n_keypoints': n_kp})
            elif self.path == '/metrics':
                self._json(200, batcher.metrics())
            else:
                self._json(404, {'error': 'not found'})

        def do_POST(self):
            if self.path != '/v1/poses':
                self._json(404, {'error': 'not found'})
                return
            length = int(self.headers.get('Content-Length', 0))
            if length <= 0:
                self._json(400, {'error': 'empty body'})
                return
            raw = self.rfile.read(length)
            try:
                img = codec.decode(raw)
            except ValueError:
                self._json(400, {'error': 'undecodable image'})
                return
            h, w = img.shape[:2]
            t0 = time.monotonic()
            fimg, _, meta = preprocess_eval(
                img, np.zeros((0, n_kp, 4), np.float32), eval_cfg, n_kp)
            try:
                poses = batcher.submit(fimg, meta,
                                       timeout=args.request_timeout_s)
            except Exception as e:
                self._json(500, {'error': f'{type(e).__name__}: {e}'})
                return
            self._json(200, {
                'image': {'width': w, 'height': h},
                'poses': poses_to_json(poses),
                'latency_ms': round((time.monotonic() - t0) * 1e3, 1)})

    class Server(ThreadingHTTPServer):
        daemon_threads = True

        def server_close(self):
            super().server_close()
            batcher.close()

    server = Server((args.host, args.port), Handler)
    server.batcher = batcher
    return server


def main(argv=None):
    args = cli(argv)
    dev = resolve_device(args.device)
    model_cfg = model_config(args, SkeletonConfig.for_dataset(args.dataset))
    infer, skeleton, eval_cfg, _ = build_infer(
        args, model_cfg, load_weights(args, model_cfg), dev)
    s = eval_cfg.long_edge
    print(f'warming up the ({eval_cfg.batch_size}, {s}, {s}) batch on '
          f'{dev}...', flush=True)
    warm = torch.zeros((eval_cfg.batch_size, s, s, 3), dtype=torch.uint8,
                       device=dev)
    infer(warm)[2].cpu()                  # block: warm before serving
    server = make_server(args, infer, skeleton, eval_cfg)
    host, port = server.server_address[:2]
    print(f'serving on http://{host}:{port} '
          f'(POST /v1/poses, GET /healthz, GET /metrics)', flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == '__main__':
    import sys
    sys.exit(main())
