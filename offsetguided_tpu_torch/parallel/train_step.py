"""Training step: loss, gradients, the explosion guard, optimizer, schedules.

Port of the JAX package's `parallel/train_step.py`, on one device or as
one rank of a data-parallel group (`TrainStep(..., group=...)`). The
model's train-mode forward carries the compute policy (bf16 autocast
backbone, fp32 parameters and BatchNorm statistics) and updates the
BatchNorm running statistics; the optimizer updates match optax's:
- `adam`: m_hat / (sqrt(v_hat) + eps), eps 1e-8 (`torch.optim.Adam` computes
  the same update); with `opt_state_dtype='bfloat16'`, `AdamLowPrecision`
  keeps the moments in bf16 and does the update in fp32;
- `sgd`: momentum trace t = g + momentum * t, step lr * t
  (`torch.optim.SGD`);
- weight decay adds wd * param to the gradient before either;
- a frozen parameter (`--freeze`) has its gradient zeroed before the clip,
  as optax's `masked(set_to_zero)` at the head of the chain: the global
  norm covers the trainable parameters, and weight decay and the moments
  still act on the frozen ones.
The learning rate of a step is the schedule at optax's count: the number
of steps taken before it.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from ..config.defaults import LossConfig, TrainConfig
from ..models.layers import sync_batchnorm
from ..ops.image import normalize_images
from ..ops.losses import compute_losses, global_losses


class AdamLowPrecision(torch.optim.Optimizer):
    """Adam whose moments are STORED in `state_dtype` (bf16 halves the
    optimizer's memory and traffic); the update runs in fp32: the moments
    are widened, updated, used and rounded back, so the only loss is the
    storage rounding between steps. With fp32 state it is optax's adam."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 state_dtype: torch.dtype = torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))
        self.state_dtype = state_dtype

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group['betas']
            for p in group['params']:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st['step'] = 0
                    st['exp_avg'] = torch.zeros_like(p, dtype=self.state_dtype)
                    st['exp_avg_sq'] = torch.zeros_like(
                        p, dtype=self.state_dtype)
                st['step'] += 1
                bc1 = 1.0 - b1 ** st['step']
                bc2 = 1.0 - b2 ** st['step']
                g = p.grad.float()
                if group['weight_decay']:
                    g = g + group['weight_decay'] * p.float()
                m = b1 * st['exp_avg'].float() + (1.0 - b1) * g
                v = b2 * st['exp_avg_sq'].float() + (1.0 - b2) * g * g
                upd = (m / bc1) / (torch.sqrt(v / bc2) + group['eps'])
                p.add_(upd.to(p.dtype), alpha=-group['lr'])
                st['exp_avg'].copy_(m)
                st['exp_avg_sq'].copy_(v)


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Optimizer:
    """The optimizer of `cfg` over `params`, at lr `cfg.learning_rate`
    (`TrainStep` sets each step's lr from its schedule)."""
    lr, wd = cfg.learning_rate, cfg.weight_decay
    if cfg.optimizer == 'adam':
        if cfg.opt_state_dtype == 'float32':
            return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=wd)
        return AdamLowPrecision(params, lr=lr, weight_decay=wd,
                                state_dtype=getattr(torch,
                                                    cfg.opt_state_dtype))
    if cfg.optimizer == 'sgd':
        return torch.optim.SGD(params, lr=lr, momentum=cfg.momentum,
                               weight_decay=wd)
    raise ValueError(cfg.optimizer)


def clip_by_global_norm_(grads, max_norm: float) -> None:
    """Scale `grads` in place to a global L2 norm of at most `max_norm`
    (optax.clip_by_global_norm)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.where(norm < max_norm,
                                           torch.ones_like(norm),
                                           max_norm / norm))


def _sum_gradients(group, bucket):
    """DDP communication hook: the ranks' gradients SUMMED (DDP's own hook
    averages them)."""
    fut = dist.all_reduce(bucket.buffer(), group=group,
                          async_op=True).get_future()
    return fut.then(lambda f: f.value()[0])


def data_parallel(model, loss_cfg: LossConfig, group):
    """`model` wrapped in DistributedDataParallel for `TrainStep`: its
    BatchNorms synchronized over `group`, the gradients summed (a comm
    hook), no buffer broadcast (the synchronized running statistics are
    equal on every rank already), and the unused-parameter search only
    where a head's parameters take no gradient: a spread tower without the
    Laplace offset loss (the fused 1x1 heads give the spread rows a zero
    gradient through their one matmul). Frozen parameters (`--freeze`)
    stay in the reducer: `TrainStep` zeroes their summed gradients, so
    they need no unused-parameter search either."""
    from torch.nn.parallel import DistributedDataParallel
    sync_batchnorm(model, group)
    dev = next(model.parameters()).device
    heads = model.cfg.heads
    unused = (heads.tower and heads.include_spread
              and loss_cfg.offset_loss != 'offset_laplace')
    ddp = DistributedDataParallel(
        model, device_ids=[dev] if dev.type == 'cuda' else None,
        broadcast_buffers=False, find_unused_parameters=unused,
        process_group=group)
    ddp.register_comm_hook(group, _sum_gradients)
    return ddp


class TrainStep:
    """`step(images, targets, mask) -> metrics`: forward in train mode on
    uint8 images (normalized here), losses, backward, the explosion guard,
    one optimizer step. A non-finite total, or one >= `explosion_guard`,
    zeroes the gradients and the optimizer still steps, as optax does;
    `metrics['skipped']` records it. (The JAX step multiplies the gradients
    by 0, which leaves NaN where a total overflowed to inf; here they are
    set to 0.)
    With `max_grad_norm`, gradients of a larger global norm are scaled to
    it first (optax's clip_by_global_norm). The gradients of the `frozen`
    parameters are zeroed before that, never dropped: a parameter without
    a gradient would be skipped by the optimizer, where the JAX chain
    still decays it. Metrics stay on the device: reading them waits for
    the step.

    With a process `group` (data parallel, each rank given its slice of
    the global batch) the step is the JAX step on the sharded batch: the
    model runs under `data_parallel` (global BatchNorm statistics), each
    rank's loss is its share of the global loss (`compute_losses` with the
    global normalizers), so the global gradient is the SUM of the ranks'
    gradients, which DDP's comm hook all-reduces during the backward; the
    clip then sees the global gradient, and the explosion guard and the
    metrics read the global losses (`global_losses`), so every rank skips
    the same steps and the weights stay equal. `self.model` stays the bare
    module (checkpoints, evaluation)."""

    def __init__(self, model, optimizer: torch.optim.Optimizer,
                 loss_cfg: LossConfig,
                 lr_schedule: Optional[Callable[[int], float]] = None,
                 explosion_guard: float = 1e8,
                 max_grad_norm: Optional[float] = None, group=None,
                 frozen: Sequence[torch.nn.Parameter] = ()):
        self.model = model
        self.optimizer = optimizer
        self.loss_cfg = loss_cfg
        self.lr_schedule = lr_schedule
        self.explosion_guard = explosion_guard
        self.max_grad_norm = max_grad_norm
        self.group = group
        self.frozen = list(frozen)
        self.net = (model if group is None
                    else data_parallel(model, loss_cfg, group))
        self.step = 0

    def __call__(self, images, targets, mask) -> Dict[str, torch.Tensor]:
        self.model.train()
        if self.lr_schedule is not None:
            for pg in self.optimizer.param_groups:
                pg['lr'] = self.lr_schedule(self.step)
        self.optimizer.zero_grad(set_to_none=True)
        out = self.net(normalize_images(images))
        losses = compute_losses(out, targets, mask, self.loss_cfg,
                                self.group)
        losses['total'].backward()
        losses = global_losses(losses, self.group)
        total = losses['total']
        ok = torch.isfinite(total) & (total < self.explosion_guard)
        if self.frozen:
            for p in self.frozen:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            torch._foreach_zero_([p.grad for p in self.frozen])
        grads = [p.grad for g in self.optimizer.param_groups
                 for p in g['params'] if p.grad is not None]
        for g in grads:
            g.masked_fill_(~ok, 0.0)
        if self.max_grad_norm:
            clip_by_global_norm_(grads, self.max_grad_norm)
        self.optimizer.step()
        self.step += 1
        metrics = dict(losses)
        metrics['skipped'] = (~ok).to(torch.float32)
        return metrics


def make_eval_step(model, loss_cfg: LossConfig, group=None):
    """Validation losses of a batch with the running statistics, in the
    train step's compute dtype; with a process `group`, each rank gives
    its slice and every rank gets the global batch's losses (the JAX
    `eval_step` on the sharded batch)."""

    @torch.no_grad()
    def eval_step(images, targets, mask) -> Dict[str, torch.Tensor]:
        model.eval()
        x = normalize_images(images)
        with model.autocast(x.device.type):
            out = model(x)
        return global_losses(compute_losses(out, targets, mask, loss_cfg,
                                            group), group)

    return eval_step


def cyclic_lr_schedule(cfg: TrainConfig, steps_per_epoch: int,
                       cycle_epochs: int = 10, min_factor: float = 0.1):
    """SWA-style cyclic schedule: the LR decays linearly within each cycle
    of `cycle_epochs` epochs, from the base to `min_factor` of it."""
    base = cfg.learning_rate

    def schedule(step: int) -> float:
        epoch = step / steps_per_epoch
        t = (epoch % cycle_epochs) / cycle_epochs
        return base * (1.0 - (1.0 - min_factor) * t)

    return schedule


def step_lr_schedule(cfg: TrainConfig, steps_per_epoch: int):
    """Optional linear warm-up, then a drop by `lr_drop_factor` at each of
    `lr_drop_epochs`."""
    base = cfg.learning_rate

    def schedule(step: int) -> float:
        epoch = step / steps_per_epoch
        lr = base
        if cfg.warmup_epochs and epoch < cfg.warmup_epochs:
            lr = base * (step + 1) / (cfg.warmup_epochs * steps_per_epoch)
        for e in cfg.lr_drop_epochs:
            if epoch >= e:
                lr *= cfg.lr_drop_factor
        return lr

    return schedule
