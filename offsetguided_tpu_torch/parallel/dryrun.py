"""The multi-process dry run: the port's counterpart of the JAX package's
`__graft_entry__.dryrun_multichip` / `_dryrun_impl`.

`dryrun_multichip(n)` spawns `n` gloo ranks (all sharing the card by
default, or on the CPU with `device='cpu'`) and runs, on the dry run's narrow
Hourglass-104 (two stacks, `dims=(32, 32, 64)`, `modules=(1, 1, 1)`,
`cnv_dim=32`, 32 x 32 images, a global batch of `n`, one image a rank):

- one data-parallel training step (`TrainStep` with the group) on the
  JAX dry run's all-zero heatmaps, all-inf offsets and all-NaN scales;
- forward + decode of each rank's slice (`topk=4`, `max_poses=4`);
- `augment_batch_dict` on each rank's slice (identity matrices);

and asserts what `_dryrun_impl` asserts (one step taken, a finite loss,
the poses' and the warped images' shapes), plus finite poses and
parameters that are bit-equal on every rank after the step.

The JAX dry run also shards the wide convolutions over a `model` axis
(`n_model = 2`). No trainer uses that axis (`make_mesh(n_data, 1)`), so
the port covers the `data` axis only.

    python -c "from offsetguided_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip(2)"          # on the card
    python -c "from offsetguided_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip(2, device='cpu')"
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

HW = 32          # image side; the outputs are HW // 4
J, L = 17, 19


def dryrun_multichip(n_devices: int, device: Optional[str] = None,
                     timeout: float = 600.0) -> List[Dict]:
    """Run the dry run on `n_devices` spawned ranks, on the device that
    `resolve_device(device)` gives (the card unless `device='cpu'`);
    returns each rank's record (`rank`, `loss`, `poses_shape`,
    `aug_shape`, `checksum`). Raises if a rank fails an assertion."""
    from ..device import resolve_device
    from . import distributed
    resolve_device(device)          # no card: raise here, before spawning
    out = distributed.spawn(_dryrun_rank, n_devices, device, timeout=timeout)
    sums = {r['checksum'] for r in out}
    if len(sums) != 1:
        raise AssertionError(f'ranks disagree after the step: {sums}')
    return out


def _dryrun_rank(rank: int, world: int, port: int, device: str) -> Dict:
    import torch
    from . import distributed
    torch.set_num_threads(1)        # the ranks share the host's cores
    dev = distributed.init_distributed(f'localhost:{port}', world, rank,
                                       device, share_device=True)
    try:
        return dryrun_impl(dev)
    finally:
        distributed.destroy()


def dryrun_impl(dev) -> Dict:
    """One rank's share of the dry run, in a process group already."""
    import torch
    from ..config.defaults import (DecoderConfig, HeadsConfig, LossConfig,
                                   ModelConfig, TrainConfig)
    from ..decoder import PostProcessor
    from ..eval.harness import make_infer_fn
    from ..models import PoseNet
    from ..models.network import init_reference_
    from ..ops.augment import augment_batch_dict
    from ..ops.encoder import Targets
    from . import distributed as D
    from .train_step import TrainStep, make_optimizer

    cfg = ModelConfig(n_stacks=2, hg_order=2, dims=(32, 32, 64),
                      modules=(1, 1, 1), cnv_dim=32, compute_dtype='float32',
                      heads=HeadsConfig())
    model = init_reference_(PoseNet(cfg),
                            torch.Generator().manual_seed(0)).to(
        dev, memory_format=torch.channels_last)
    batch, out_hw = D.world(), HW // 4
    n = batch // D.world()

    def full(shape, value):
        return D.local_slice(torch.full((batch, *shape), value,
                                        dtype=torch.float32)).to(dev)

    targets = Targets(
        hmp=full((out_hw, out_hw, J), 0.0), bg=full((out_hw, out_hw, 1), 1.0),
        jomp=full((out_hw, out_hw, 2), float('inf')),
        omp=full((out_hw, out_hw, 2 * L), float('inf')),
        scmp=full((out_hw, out_hw, J), float('nan')),
        pscmp=full((out_hw, out_hw, 2 * L), 1.0))
    mask = torch.ones((n, out_hw, out_hw, 1), dtype=torch.bool, device=dev)
    images = torch.zeros((n, HW, HW, 3), dtype=torch.uint8, device=dev)

    step = TrainStep(model, make_optimizer(TrainConfig(learning_rate=1e-4),
                                           model.parameters()),
                     LossConfig(), group=D.group())
    metrics = step(images, targets, mask)
    loss = float(metrics['total'])
    assert step.step == 1 and float(metrics['skipped']) == 0.0
    assert np.isfinite(loss), loss

    infer = make_infer_fn(model.eval(), PostProcessor(
        cfg=DecoderConfig(topk=4, max_poses=4)), flip_test=False)
    poses, _, _ = infer(images)
    assert tuple(poses.shape) == (n, 4, J, 6), poses.shape
    assert bool(torch.isfinite(poses).all())

    eye = torch.eye(3, device=dev).expand(n, 3, 3)
    aug = {
        'image': torch.zeros((n, HW, HW, 3), dtype=torch.uint8, device=dev),
        'mask_miss': torch.full((n, HW, HW), 255, dtype=torch.uint8,
                                device=dev),
        'anns': torch.zeros((n, 4, J, 4), device=dev),
        'aug_mat': eye.contiguous(),
        'aug_mat_inv': eye[:, :2].contiguous(),
        'aug_scale_xy': torch.ones((n, 2), device=dev),
        'aug_flags': torch.zeros((n, 2), device=dev),
        'aug_tint': torch.zeros((n, 4), device=dev),
        'valid_hw': torch.full((n, 2), HW, dtype=torch.int32, device=dev),
    }
    a_imgs, _, _ = augment_batch_dict(aug, HW, [1, 3], [2, 4])
    assert tuple(a_imgs.shape) == (n, HW, HW, 3), a_imgs.shape

    return dict(rank=D.rank(), loss=loss, poses_shape=tuple(poses.shape),
                aug_shape=tuple(a_imgs.shape),
                checksum=D.state_digest(model))
