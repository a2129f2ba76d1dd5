"""Data-parallel process groups: the port's counterpart of the JAX
package's `data` mesh axis (`parallel/mesh.py`) and of the trainer's
`jax.distributed.initialize` (`cli/train.py`).

The JAX trainer runs one jit program over a batch sharded on `data`; here
each process is one rank of a `torch.distributed` group, holds one device
and feeds its contiguous slice of the global batch, as each JAX process
does (`local_slice`). What jit made global follows by collectives: the
BatchNorm statistics (`models/layers.py`), the loss normalizers
(`ops/losses.py`) and the gradient sum (`parallel/train_step.py`).

Backend: NCCL on CUDA devices, gloo on the CPU, and gloo as well when the
ranks share one card (`share_device=True`, asked for explicitly: NCCL
needs a card per rank). With no process group every helper is the
identity, so one process runs as it does without `--distributed`.

Launch: the trainer's `--distributed` with `--coordinator-address
host:port --num-processes N --process-id R` in each process (JAX's
flags), or under `torchrun`, whose RANK / WORLD_SIZE / LOCAL_RANK /
MASTER_ADDR / MASTER_PORT play the part of JAX's auto-detection.
"""
from __future__ import annotations

import os
import socket
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: Optional[str] = None,
                     share_device: bool = False) -> torch.device:
    """Join the process group; returns this rank's device.

    With `coordinator_address` ('host:port' or 'tcp://host:port') the
    group rendezvouses there with `num_processes` and `process_id`;
    without it, at `env://` (torchrun's variables). The device is as
    `resolve_device` gives it (the card unless told otherwise); a CUDA
    device without an index is `cuda:LOCAL_RANK` (LOCAL_RANK from the
    environment, else the rank modulo the cards)."""
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError('--coordinator-address needs --num-processes '
                             'and --process-id')
        addr = coordinator_address
        init = addr if addr.startswith('tcp://') else f'tcp://{addr}'
        kw = dict(init_method=init, world_size=num_processes,
                  rank=process_id)
    else:
        kw = dict(init_method='env://')
    dev = resolve_device(device)
    if dev.type == 'cuda':
        if dev.index is None:
            rank_ = process_id if process_id is not None else int(
                os.environ.get('RANK', 0))
            dev = torch.device('cuda', int(os.environ.get(
                'LOCAL_RANK', rank_ % torch.cuda.device_count())))
        torch.cuda.set_device(dev)
    backend = 'nccl' if dev.type == 'cuda' and not share_device else 'gloo'
    dist.init_process_group(backend, **kw)
    return dev


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def is_primary() -> bool:
    return rank() == 0


def group():
    """The default process group, or None without one (the layers and
    losses take this: None means one process)."""
    return dist.group.WORLD if active() else None


def local_slice(arr):
    """This rank's contiguous slice of a global batch (an array, tensor or
    list along its first axis), as the JAX trainer's `put` takes it; the
    batch must divide by the world size, as there."""
    n, w = len(arr), world()
    assert n % w == 0, (n, w)
    per = n // w
    return arr[rank() * per:(rank() + 1) * per]


def local_batch(batch: dict) -> dict:
    """`local_slice` of every per-sample entry of a loader batch (arrays
    and the `metas` list); scalars such as `epoch` stay."""
    if world() == 1:
        return batch
    return {k: (local_slice(v) if isinstance(v, (np.ndarray, list)) else v)
            for k, v in batch.items()}


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of `t` over the ranks, in place; `t` itself without a group."""
    if active():
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def barrier() -> None:
    if active():
        nccl = dist.get_backend() == 'nccl'
        dist.barrier(device_ids=[torch.cuda.current_device()] if nccl
                     else None)


def destroy() -> None:
    if active():
        dist.destroy_process_group()


def state_digest(model) -> str:
    """SHA-256 of a model's parameters and buffers, byte for byte: equal
    on two ranks exactly when their weights are bit-equal."""
    import hashlib
    h = hashlib.sha256()
    for k, v in sorted(model.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _spawned(fn, rank_, world_, port, args, queue):
    try:
        queue.put((rank_, fn(rank_, world_, port, *args), None))
    except BaseException as e:  # noqa: BLE001 - reported to the parent
        import traceback
        queue.put((rank_, None, traceback.format_exc()))
        raise SystemExit(1) from e


def spawn(fn: Callable, n: int, *args, timeout: float = 600.0) -> list:
    """Run `fn(rank, n, port, *args)` in `n` spawned processes (a fresh
    localhost port for their rendezvous) and return the ranks' results in
    rank order. A rank's exception is raised here with its traceback, as
    is a rank that dies without a result or a run past `timeout` seconds;
    the other ranks are then stopped. `fn` must be importable by module
    path (spawn pickles it by name)."""
    import multiprocessing as mp
    import queue as queue_mod
    import time
    ctx = mp.get_context('spawn')
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_spawned, args=(fn, r, n, port, args, queue))
             for r in range(n)]
    for p in procs:
        p.start()
    results, errors, done = [None] * n, [], set()
    deadline = time.monotonic() + timeout
    try:
        while len(done) < n and not errors:
            try:
                r, out, err = queue.get(timeout=1.0)
            except queue_mod.Empty:
                lost = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if lost:
                    errors.append(f'ranks {lost} died without a result')
                elif time.monotonic() > deadline:
                    errors.append(f'no result within {timeout} s')
                continue
            done.add(r)
            results[r] = out
            if err:
                errors.append(f'rank {r}:\n{err}')
    finally:
        for p in procs:
            p.join(timeout=5 if errors else timeout)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError('\n'.join(errors))
    return results
