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
gives) onto this package's PoseNet state dict, and `jax_from_state_dict`
back, through one key map (`key_map`): convolution kernels go from HWIO to
OIHW, Dense kernels from (in, out) to (out, in). For Hourglass-104 the map
is this package's own copy of the JAX package's `_torch_hourglass_names` /
`_head_names` (module construction order of the flax tree against the
reference module tree). The 4-stage net and the 3x3 tower heads have no
reference names and no torch key map in the JAX package; the port names
them itself (`hourglass4stage_names`), in construction order of the flax
tree:
- `DilatedStem_0/ConvBN_0` -> `basenet.stem.conv`,
  `DilatedStem_0/BottleneckResidual_{0,1}` -> `basenet.stem.res{1,2}`,
  `DilatedStem_0/ConvBN_{1..6}` -> `basenet.stem.dilated.{0..5}`;
- `HourglassBlock_{s}` -> `basenet.hgs.{s}`: its `BottleneckResidual_0`
  -> `up1`, `_1` -> `low1`, `HourglassBlock_0` (or, at order 1,
  `BottleneckResidual_2`) -> `low2`, the last `BottleneckResidual` ->
  `low3`;
- a bottleneck's `Conv_i` / `BatchNorm_i` -> `conv{i+1}` / `bn{i+1}` for i
  < 3, `Conv_3` / `BatchNorm_3` (the projected skip) -> `skip.0` /
  `skip.1`;
- per stack s, the backbone's next two `ConvBN`s -> `basenet.features.{s}.0`
  and `.1`, `SELayer_{s}/Dense_{0,1}` -> `basenet.features.{s}.2.fc{1,2}`,
  and between stacks the next `ConvBN` -> `basenet.feedback.{s}`;
- a tower head's `PoseHeads_0/<head>_{s}/Conv_{0,1}` -> its `Sequential`'s
  `.0` and `.2`.
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


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    out: Dict = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split('/')
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def hourglass_names(cfg: ModelConfig) -> List[Tuple[str, str, str]]:
    """Hourglass104: (flax path in the backbone, torch prefix, kind) in
    construction order; kind is 'convbn', 'convbn_seq' or 'residual'."""
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


def hourglass4stage_names(cfg: ModelConfig) -> List[Tuple[str, str, str]]:
    """The 4-stage net: (flax path in the backbone, torch prefix, kind) in
    construction order; kind is 'convbn', 'bottleneck' or 'se'."""
    pairs = [('DilatedStem_0/ConvBN_0', 'basenet.stem.conv', 'convbn'),
             ('DilatedStem_0/BottleneckResidual_0', 'basenet.stem.res1',
              'bottleneck'),
             ('DilatedStem_0/BottleneckResidual_1', 'basenet.stem.res2',
              'bottleneck')]
    pairs += [(f'DilatedStem_0/ConvBN_{i + 1}', f'basenet.stem.dilated.{i}',
               'convbn') for i in range(6)]

    def block(fp: str, tp: str, depth: int):
        pairs.append((f'{fp}/BottleneckResidual_0', f'{tp}.up1',
                      'bottleneck'))
        pairs.append((f'{fp}/BottleneckResidual_1', f'{tp}.low1',
                      'bottleneck'))
        if depth > 1:
            block(f'{fp}/HourglassBlock_0', f'{tp}.low2', depth - 1)
        else:
            pairs.append((f'{fp}/BottleneckResidual_2', f'{tp}.low2',
                          'bottleneck'))
        pairs.append((f'{fp}/BottleneckResidual_{3 if depth == 1 else 2}',
                      f'{tp}.low3', 'bottleneck'))

    conv_i = 0
    for s in range(cfg.n_stacks):
        block(f'HourglassBlock_{s}', f'basenet.hgs.{s}', 4)
        pairs.append((f'ConvBN_{conv_i}', f'basenet.features.{s}.0',
                      'convbn'))
        pairs.append((f'ConvBN_{conv_i + 1}', f'basenet.features.{s}.1',
                      'convbn'))
        pairs.append((f'SELayer_{s}', f'basenet.features.{s}.2', 'se'))
        conv_i += 2
        if s < cfg.n_stacks - 1:
            pairs.append((f'ConvBN_{conv_i}', f'basenet.feedback.{s}',
                          'convbn'))
            conv_i += 1
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


# one entry of the key map: (collection, flax leaf path, torch key, kind,
# optional); kind 'conv' is an HWIO kernel (OIHW in torch), 'dense' an
# (in, out) kernel ((out, in) in torch), 'vec' a vector; an optional entry
# (a projection skip) is carried where the source has it
_Entry = Tuple[str, str, str, str, bool]


def key_map(cfg: ModelConfig) -> List[_Entry]:
    """Every leaf of the JAX PoseNet's `{'params', 'batch_stats'}` tree
    and its key in this package's PoseNet state dict."""
    cfg = backbone_config(cfg)
    out: List[_Entry] = []

    def conv(fp, tp, optional=False):
        out.append(('params', f'{fp}/kernel', f'{tp}.weight', 'conv',
                    optional))

    def bn(fp, tp, optional=False):
        for col, f, t in (('params', 'scale', 'weight'),
                          ('params', 'bias', 'bias'),
                          ('batch_stats', 'mean', 'running_mean'),
                          ('batch_stats', 'var', 'running_var')):
            out.append((col, f'{fp}/{f}', f'{tp}.{t}', 'vec', optional))

    def conv_bn(fp, i, conv_t, bn_t, optional=False):
        conv(f'{fp}/Conv_{i}', conv_t, optional)
        bn(f'{fp}/BatchNorm_{i}', bn_t, optional)

    if cfg.basenet == 'hourglass4stage':
        bb, names = 'Hourglass4Stage_0', hourglass4stage_names(cfg)
    else:
        bb, names = 'Hourglass104_0', hourglass_names(cfg)
    for flax_path, tp, kind in names:
        fp = f'{bb}/{flax_path}'
        if kind in ('residual', 'bottleneck'):
            conv_bn(fp, 0, f'{tp}.conv1', f'{tp}.bn1')
            conv_bn(fp, 1, f'{tp}.conv2', f'{tp}.bn2')
            if kind == 'bottleneck':
                conv_bn(fp, 2, f'{tp}.conv3', f'{tp}.bn3')
            i = 3 if kind == 'bottleneck' else 2
            conv_bn(fp, i, f'{tp}.skip.0', f'{tp}.skip.1', optional=True)
        elif kind == 'se':
            for i in (0, 1):
                out.append(('params', f'{fp}/Dense_{i}/kernel',
                            f'{tp}.fc{i + 1}.weight', 'dense', False))
                out.append(('params', f'{fp}/Dense_{i}/bias',
                            f'{tp}.fc{i + 1}.bias', 'vec', False))
        elif kind == 'convbn_seq':
            conv_bn(fp, 0, f'{tp}.0', f'{tp}.1')
        else:
            conv_bn(fp, 0, f'{tp}.conv', f'{tp}.bn')

    for flax_name, tp in head_names(cfg):
        fp = f'PoseHeads_0/{flax_name}'
        layers = ((f'{fp}/Conv_0', f'{tp}.0'), (f'{fp}/Conv_1', f'{tp}.2')) \
            if cfg.heads.tower else ((fp, tp),)
        for f, t in layers:
            conv(f, t)
            out.append(('params', f'{f}/bias', f'{t}.bias', 'vec', False))
    return out


def state_dict_from_jax(variables_np: Dict, cfg: ModelConfig
                        ) -> Dict[str, torch.Tensor]:
    """JAX PoseNet variables -> this package's PoseNet state dict."""
    flat = {col: _flatten(variables_np[col])
            for col in ('params', 'batch_stats')}
    sd: Dict[str, np.ndarray] = {}
    for col, fk, tk, kind, optional in key_map(cfg):
        if optional and fk not in flat[col]:
            continue
        v = np.asarray(flat[col][fk], np.float32)
        if kind == 'conv':
            v = v.transpose(3, 2, 0, 1)            # HWIO -> OIHW
        elif kind == 'dense':
            v = v.T
        sd[tk] = np.ascontiguousarray(v)
        if tk.endswith('.running_var'):
            sd[tk[:-len('running_var')] + 'num_batches_tracked'] = \
                np.asarray(0, np.int64)
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
    flat: Dict[str, Dict[str, np.ndarray]] = {'params': {}, 'batch_stats': {}}
    for col, fk, tk, kind, optional in key_map(cfg):
        if optional and tk not in sd:
            continue
        v = sd[tk].detach().cpu().float().numpy()
        if kind == 'conv':
            v = v.transpose(2, 3, 1, 0)            # OIHW -> HWIO
        elif kind == 'dense':
            v = v.T
        flat[col][fk] = np.ascontiguousarray(v)
    return {col: _unflatten(v) for col, v in flat.items()}


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
