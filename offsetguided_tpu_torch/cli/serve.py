"""Serving core: model + decoder behind a cross-request micro-batcher.

`build_infer` makes the model (random seeded weights or JAX weights through
`models.checkpoint.state_dict_from_jax`), the decoder and the batched infer
function on one device. `Batcher` collects up to `batch_size` requests within
`window_ms`, zero-pads them to the batch shape, runs one infer and answers
each request with its poses in original image coordinates. The HTTP front
end and JPEG decoding come with a later part of the port.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..config.defaults import (DecoderConfig, EvalConfig, ModelConfig,
                               SkeletonConfig)
from ..data import transforms as T
from ..decoder import PostProcessor
from ..device import resolve_device
from ..eval.harness import make_infer_fn
from ..models import PoseNet, random_posenet


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The serve defaults of the JAX package's `cli/serve.py`."""
    long_edge: int = 640
    flip_test: bool = False
    batch_size: int = 8
    batch_window_ms: float = 5.0
    topk: int = 32
    thre_hmp: float = 0.04
    dist_max: float = 40.0
    person_thre: float = 0.06
    min_len: float = 0.5
    sort_dim: int = 2
    resize_mode: str = 'bicubic'


def build_infer(args: ServeConfig, model_cfg: ModelConfig = ModelConfig(),
                state_dict: Optional[dict] = None, device=None,
                seed: int = 0):
    """-> (infer, skeleton, eval_cfg, model). Without a `state_dict` the
    weights are `random_posenet(seed)`, calibrated at `args.long_edge`."""
    dev = resolve_device(device)
    skeleton = SkeletonConfig()
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
        sort_dim=args.sort_dim, resize_mode=args.resize_mode))
    eval_cfg = EvalConfig(long_edge=args.long_edge, flip_test=args.flip_test,
                          batch_size=args.batch_size)
    infer = make_infer_fn(model, pp, args.flip_test)
    return infer, skeleton, eval_cfg, model


class Batcher:
    """Cross-request micro-batching onto one fixed batch shape.

    Requests enqueue (uint8 image, meta); one dispatcher thread collects up
    to `batch_size` of them within `window_ms`, zero-pads to the batch
    shape, runs `infer` once on `device`, and hands each request its
    inverse-transformed poses. `close()` stops the thread."""

    def __init__(self, infer, batch_size: int, window_ms: float, device):
        self._infer = infer
        self._bs = batch_size
        self._window = window_ms / 1e3
        self._device = torch.device(device)
        self._q: queue.Queue = queue.Queue()
        self._mlock = threading.Lock()
        self.n_requests = 0
        self.n_batches = 0
        self.n_errors = 0
        self._lat_ring = []
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def metrics(self) -> dict:
        """Requests, batches and errors so far, and the median device-batch
        latency over the last 512 batches (None before the first)."""
        with self._mlock:
            lats = sorted(self._lat_ring)
            return {
                'requests': self.n_requests,
                'batches': self.n_batches,
                'errors': self.n_errors,
                'device_batch_p50_ms': (lats[len(lats) // 2] * 1e3
                                        if lats else None),
            }

    def submit(self, image: np.ndarray, meta, timeout: float = 60.0):
        """Blocks until this request's batch returns; poses in original
        image coordinates, shape (M, J, 6)."""
        ev = threading.Event()
        slot = {}
        self._q.put((image, meta, ev, slot))
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
            self._run(batch)
            if stop:
                return

    def _run(self, batch):
        imgs = [b[0] for b in batch]
        while len(imgs) < self._bs:
            imgs.append(np.zeros_like(imgs[0]))
        t0 = time.monotonic()
        err = 0
        try:
            x = torch.from_numpy(np.stack(imgs)).to(self._device)
            poses, _, counts = self._infer(x)
            poses = poses.cpu().numpy()
            counts = counts.cpu().numpy()
            for i, (_, meta, ev, slot) in enumerate(batch):
                slot['poses'] = T.annotations_inverse(
                    poses[i][:int(counts[i])], meta)
                ev.set()
        except Exception as e:  # every waiter of the batch sees the error
            for _, _, ev, slot in batch:
                slot['error'] = e
                ev.set()
            err = len(batch)
        with self._mlock:
            self.n_requests += len(batch)
            self.n_batches += 1
            self.n_errors += err
            self._lat_ring.append(time.monotonic() - t0)
            if len(self._lat_ring) > 512:
                del self._lat_ring[0]
