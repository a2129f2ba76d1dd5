"""Training checkpoints, and weights carried across from the JAX package or
a reference checkpoint.

`save_checkpoint` / `load_checkpoint` / `latest_checkpoint` keep the
port's own training checkpoints: `torch.save` of the model state dict, the
optimizer state, the step, the epoch and the loss, one file an epoch
(`posenet_<epoch>.pt`).

`load_reference_checkpoint` reads a reference `.pth` file into a state dict
for this package's PoseNet, whose modules keep the reference names.
`state_dict_from_jax` maps the JAX `{'params', 'batch_stats'}` tree (nested
dicts of numpy arrays, as `jax.tree_util.tree_map(np.asarray, variables)`
gives) onto this package's PoseNet state dict. The key map is this package's
own copy of the JAX package's `_torch_hourglass_names` / `_head_names`
(module construction order of the flax tree against the reference module
tree); convolution kernels go from HWIO to OIHW.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config.defaults import ModelConfig
from .network import backbone_config


def _flatten(tree: Dict, prefix: str = '') -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f'{prefix}/{k}' if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def hourglass_names(cfg: ModelConfig) -> List[Tuple[str, str, str]]:
    """(flax path in the backbone, torch prefix, kind) in construction
    order; kind is 'convbn', 'convbn_seq' or 'residual'."""
    pairs = [('ConvBN_0', 'basenet.pre.0', 'convbn'),
             ('BasicResidual_0', 'basenet.pre.1', 'residual')]

    def kp_pairs(fp: str, tp: str, n: int, modules):
        curr_mod, next_mod = modules[0], modules[1]
        r = 0

        def res(torch_name):
            nonlocal r
            pairs.append((f'{fp}/BasicResidual_{r}', f'{tp}.{torch_name}',
                          'residual'))
            r += 1

        for m in range(curr_mod):
            res(f'up1.{m}')
        for m in range(curr_mod):
            res(f'low1.{m}')
        if n > 1:
            kp_pairs(f'{fp}/KPModule_0', f'{tp}.low2', n - 1, modules[1:])
        else:
            for m in range(next_mod):
                res(f'low2.{m}')
        for m in range(curr_mod):
            res(f'low3.{m}')

    conv_i, res_i = 1, 1
    for s in range(cfg.n_stacks):
        kp_pairs(f'KPModule_{s}', f'basenet.kps.{s}', cfg.hg_order,
                 tuple(cfg.modules))
        pairs.append((f'ConvBN_{conv_i}', f'basenet.cnvs.{s}', 'convbn'))
        conv_i += 1
        if s < cfg.n_stacks - 1:
            pairs.append((f'ConvBN_{conv_i}', f'basenet.inters_.{s}',
                          'convbn_seq'))
            pairs.append((f'ConvBN_{conv_i + 1}', f'basenet.cnvs_.{s}',
                          'convbn_seq'))
            conv_i += 2
            pairs.append((f'BasicResidual_{res_i}', f'basenet.inters.{s}',
                          'residual'))
            res_i += 1
    return pairs


def head_names(cfg: ModelConfig) -> List[Tuple[str, str]]:
    h = cfg.heads
    pairs = []
    for s in range(cfg.n_stacks):
        pairs.append((f'hmp_{s}', f'headnets.0.hp_convs.{s}'))
        if h.include_background:
            pairs.append((f'bg_{s}', f'headnets.0.bghp_convs.{s}'))
        if h.include_jitter_offset:
            pairs.append((f'jomp_{s}', f'headnets.0.jitter_convs.{s}'))
        pairs.append((f'omp_{s}', f'headnets.1.reg_convs.{s}'))
        if h.include_spread:
            pairs.append((f'spread_{s}', f'headnets.1.spread_convs.{s}'))
        if h.include_scale:
            pairs.append((f'scmp_{s}', f'headnets.1.scale_convs.{s}'))
    return pairs


def _oihw(w) -> np.ndarray:
    """HWIO -> OIHW."""
    return np.ascontiguousarray(np.transpose(np.asarray(w, np.float32),
                                             (3, 2, 0, 1)))


def state_dict_from_jax(variables_np: Dict, cfg: ModelConfig
                        ) -> Dict[str, torch.Tensor]:
    """JAX PoseNet variables -> this package's PoseNet state dict."""
    cfg = backbone_config(cfg)
    params = _flatten(variables_np['params'])
    stats = _flatten(variables_np['batch_stats'])
    sd: Dict[str, np.ndarray] = {}

    def f32(v):
        return np.asarray(v, np.float32)

    def put_bn(fp, bn_f, tp):
        sd[f'{tp}.weight'] = f32(params[f'{fp}/{bn_f}/scale'])
        sd[f'{tp}.bias'] = f32(params[f'{fp}/{bn_f}/bias'])
        sd[f'{tp}.running_mean'] = f32(stats[f'{fp}/{bn_f}/mean'])
        sd[f'{tp}.running_var'] = f32(stats[f'{fp}/{bn_f}/var'])
        sd[f'{tp}.num_batches_tracked'] = np.asarray(0, np.int64)

    bb = 'Hourglass104_0'
    for flax_path, tp, kind in hourglass_names(cfg):
        fp = f'{bb}/{flax_path}'
        if kind == 'residual':
            sd[f'{tp}.conv1.weight'] = _oihw(params[f'{fp}/Conv_0/kernel'])
            put_bn(fp, 'BatchNorm_0', f'{tp}.bn1')
            sd[f'{tp}.conv2.weight'] = _oihw(params[f'{fp}/Conv_1/kernel'])
            put_bn(fp, 'BatchNorm_1', f'{tp}.bn2')
            if f'{fp}/Conv_2/kernel' in params:
                sd[f'{tp}.skip.0.weight'] = _oihw(
                    params[f'{fp}/Conv_2/kernel'])
                put_bn(fp, 'BatchNorm_2', f'{tp}.skip.1')
        else:
            seq = kind == 'convbn_seq'
            conv_t = f'{tp}.0' if seq else f'{tp}.conv'
            sd[f'{conv_t}.weight'] = _oihw(params[f'{fp}/Conv_0/kernel'])
            put_bn(fp, 'BatchNorm_0', f'{tp}.1' if seq else f'{tp}.bn')

    hp = 'PoseHeads_0'
    for flax_name, tp in head_names(cfg):
        sd[f'{tp}.weight'] = _oihw(params[f'{hp}/{flax_name}/kernel'])
        sd[f'{tp}.bias'] = f32(params[f'{hp}/{flax_name}/bias'])
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference `.pth` checkpoint -> PoseNet state dict: the dict under
    `model_state_dict` or `state_dict` (or the file itself), with the
    `module.` prefix of data-parallel training stripped."""
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    sd = ckpt.get('model_state_dict', ckpt.get('state_dict', ckpt))
    return {k[len('module.'):] if k.startswith('module.') else k: v
            for k, v in sd.items()}


def jax_from_state_dict(sd: Dict[str, torch.Tensor], cfg: ModelConfig
                        ) -> Dict[str, Dict]:
    """This package's PoseNet state dict -> the JAX `{'params',
    'batch_stats'}` tree (nested dicts of float32 numpy arrays): the
    inverse of `state_dict_from_jax`."""
    cfg = backbone_config(cfg)
    params: Dict[str, np.ndarray] = {}
    stats: Dict[str, np.ndarray] = {}

    def t(key):
        return sd[key].detach().cpu().float().numpy()

    def hwio(key):
        return np.ascontiguousarray(np.transpose(t(key), (2, 3, 1, 0)))

    def get_bn(fp, bn_f, tp):
        params[f'{fp}/{bn_f}/scale'] = t(f'{tp}.weight')
        params[f'{fp}/{bn_f}/bias'] = t(f'{tp}.bias')
        stats[f'{fp}/{bn_f}/mean'] = t(f'{tp}.running_mean')
        stats[f'{fp}/{bn_f}/var'] = t(f'{tp}.running_var')

    bb = 'Hourglass104_0'
    for flax_path, tp, kind in hourglass_names(cfg):
        fp = f'{bb}/{flax_path}'
        if kind == 'residual':
            params[f'{fp}/Conv_0/kernel'] = hwio(f'{tp}.conv1.weight')
            get_bn(fp, 'BatchNorm_0', f'{tp}.bn1')
            params[f'{fp}/Conv_1/kernel'] = hwio(f'{tp}.conv2.weight')
            get_bn(fp, 'BatchNorm_1', f'{tp}.bn2')
            if f'{tp}.skip.0.weight' in sd:
                params[f'{fp}/Conv_2/kernel'] = hwio(f'{tp}.skip.0.weight')
                get_bn(fp, 'BatchNorm_2', f'{tp}.skip.1')
        else:
            seq = kind == 'convbn_seq'
            conv_t = f'{tp}.0' if seq else f'{tp}.conv'
            params[f'{fp}/Conv_0/kernel'] = hwio(f'{conv_t}.weight')
            get_bn(fp, 'BatchNorm_0', f'{tp}.1' if seq else f'{tp}.bn')

    hp = 'PoseHeads_0'
    for flax_name, tp in head_names(cfg):
        params[f'{hp}/{flax_name}/kernel'] = hwio(f'{tp}.weight')
        params[f'{hp}/{flax_name}/bias'] = t(f'{tp}.bias')
    return {'params': _unflatten(params), 'batch_stats': _unflatten(stats)}


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    out: Dict = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split('/')
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _ckpt_path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f'posenet_{epoch:03d}.pt')


def save_checkpoint(ckpt_dir: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer], step: int,
                    epoch: int, train_loss: float = float('inf')) -> str:
    """Write `posenet_<epoch>.pt` in `ckpt_dir` (made if missing): the model
    state dict, the optimizer state, step, epoch and loss. Returns its
    path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _ckpt_path(ckpt_dir, epoch)
    torch.save({'model': model.state_dict(),
                'optimizer': (optimizer.state_dict() if optimizer is not None
                              else None),
                'step': int(step), 'epoch': int(epoch),
                'train_loss': float(train_loss)}, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The checkpoint of the highest epoch in `ckpt_dir`, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = sorted(p for p in os.listdir(ckpt_dir)
                   if re.match(r'posenet_\d+\.pt$', p))
    return os.path.join(os.path.abspath(ckpt_dir), cands[-1]) if cands else None


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None, *,
                    drop_optimizer: bool = False,
                    recount_epoch: bool = False) -> Tuple[int, int, float]:
    """Restore a `save_checkpoint` file into `model` (strictly) and, unless
    `drop_optimizer`, into `optimizer`. Returns (step, epoch, train_loss):
    step 0 with `drop_optimizer`, epoch 0 with `recount_epoch`."""
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    model.load_state_dict(ckpt['model'], strict=True)
    step = int(ckpt['step'])
    if drop_optimizer:
        step = 0
    elif optimizer is not None and ckpt.get('optimizer') is not None:
        optimizer.load_state_dict(ckpt['optimizer'])
    epoch = 0 if recount_epoch else int(ckpt['epoch'])
    return step, epoch, float(ckpt['train_loss'])
