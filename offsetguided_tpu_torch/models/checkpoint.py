"""Training checkpoints, and weights carried across from the JAX package or
a reference checkpoint.

`save_checkpoint` / `load_checkpoint` / `latest_checkpoint` keep the
port's own training checkpoints: `torch.save` of the model state dict, the
optimizer state, the step, the epoch and the loss, one file an epoch
(`posenet_<epoch>.pt`). `load_checkpoint` restores them leaf by leaf as the
JAX package's does (`_merge_matching`): a leaf whose flax path matches
`drop_layers`, that the file lacks or whose shape differs keeps its fresh
value. `frozen_parameters` is the JAX `freeze_mask` selection (`--freeze`).

`load_reference_checkpoint` reads a reference `.pth` file into a state dict
for this package's PoseNet, whose modules keep the reference names;
`load_reference_into` copies it into a model as the JAX package's
`convert_torch_state_dict` does, and lists what it left at the fresh init.
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


def load_reference_checkpoint(path) -> Dict[str, torch.Tensor]:
    """A reference `.pth` checkpoint (or its state dict) -> PoseNet state
    dict: the dict under `model_state_dict` or `state_dict` (or the file
    itself), with the `module.` prefix of data-parallel training stripped
    (not `module_list`), and a bare backbone's keys (the pretrained
    hourglass: `pre.*`, `kps.*`, no `basenet.*`) given the `basenet.`
    prefix."""
    ckpt = (torch.load(path, map_location='cpu', weights_only=False)
            if isinstance(path, (str, os.PathLike)) else path)
    sd = ckpt.get('model_state_dict', ckpt.get('state_dict', ckpt))
    sd = {k[len('module.'):] if k.startswith('module.')
          and not k.startswith('module_list') else k: v
          for k, v in sd.items()}
    if (not any(k.startswith('basenet.') for k in sd)
            and any(k.startswith(('pre.', 'kps.')) for k in sd)):
        sd = {f'basenet.{k}': v for k, v in sd.items()}
    return sd


def _flax_shape(shape, kind: str) -> Tuple[int, ...]:
    shape = tuple(int(d) for d in shape)
    if kind == 'conv':
        o, i, h, w = shape
        return (h, w, i, o)
    return shape[::-1] if kind == 'dense' else shape


_CONVBN_KERNEL = re.compile(r'ConvBN_\d+/Conv_0/kernel$')


@torch.no_grad()
def load_reference_into(model: torch.nn.Module, path_or_sd) -> List[str]:
    """Copy a reference `.pth` file (or state dict) into `model` as the JAX
    package's `convert_torch_state_dict` converts it: every `key_map`
    entry whose torch key is there with the model's shape is copied;
    torch keys the map does not name are ignored. Returns the unmatched
    entries in JAX's words and order, each of which keeps the model's
    fresh value: `no torch key <key>` (a missing key; a projection skip is
    taken only where the file has one), `shape mismatch <flax path>:
    <model shape> vs <file shape>` (flax layouts), `no flax param <flax
    path>` (a ConvBN conv bias, or a projection skip, the model lacks)."""
    sd = load_reference_checkpoint(path_or_sd)
    target = model.state_dict()
    unmatched: List[str] = []
    for col, fk, tk, kind, optional in key_map(model.cfg):
        v = sd.get(tk)
        if tk not in target:
            if v is not None:
                unmatched.append(f'no flax param {fk}')
            continue
        if v is None:
            if not optional:
                unmatched.append(f'no torch key {tk}')
            continue
        if tuple(v.shape) == tuple(target[tk].shape):
            target[tk].copy_(torch.as_tensor(v))
        else:
            unmatched.append(
                f'shape mismatch {fk}: {_flax_shape(target[tk].shape, kind)}'
                f' vs {_flax_shape(v.shape, kind)}')
        bias = tk[:-len('weight')] + 'bias'
        if _CONVBN_KERNEL.search(fk) and bias in sd and bias not in target:
            unmatched.append(f'no flax param {fk[:-len("kernel")]}bias')
    return unmatched


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


@torch.no_grad()
def _merge_matching(model: torch.nn.Module, saved: Dict[str, torch.Tensor],
                   drop_layers: Optional[str] = None) -> None:
    """The JAX package's `_merge_matching` of `params` and of
    `batch_stats`: each `key_map` leaf of `model` takes the saved value
    unless its flax path matches `drop_layers` (`re.search`, the path as
    `PoseHeads_0/omp_0/kernel`), the file lacks it or its shape differs;
    then it keeps the model's value. Entries outside the key map (the
    BatchNorm batch counters) are taken where present."""
    pat = re.compile(drop_layers) if drop_layers else None
    target = model.state_dict()
    mapped = set()
    for _, fk, tk, _, _ in key_map(model.cfg):
        mapped.add(tk)
        v = saved.get(tk)
        if (tk in target and v is not None
                and (pat is None or not pat.search(fk))
                and tuple(v.shape) == tuple(target[tk].shape)):
            target[tk].copy_(v)
    for k, t in target.items():
        if k not in mapped and k in saved and saved[k].shape == t.shape:
            t.copy_(saved[k])


def _restore_optimizer(path: str, optimizer: torch.optim.Optimizer,
                       saved: Dict, model: torch.nn.Module) -> None:
    """Load `saved` into `optimizer`, keeping its hyperparameters (the
    flags of this run, as the JAX optimizer takes them from its chain).
    Leaves the fresh state where the saved state is indexed over another
    number of parameters (the JAX loader's structure drift); raises where
    a restored moment would not fit its parameter."""
    params = [p for g in optimizer.param_groups for p in g['params']]
    current = [n for n, _ in model.named_parameters()]
    if ([len(g['params']) for g in saved['param_groups']]
            != [len(g['params']) for g in optimizer.param_groups]):
        return
    for i, st in saved['state'].items():
        p, name = params[int(i)], current[int(i)]
        for k, v in st.items():
            if (isinstance(v, torch.Tensor) and v.dim()
                    and tuple(v.shape) != tuple(p.shape)):
                raise ValueError(
                    f'{path}: the optimizer state {k!r} of {name} has shape '
                    f'{tuple(v.shape)}, the parameter {tuple(p.shape)}; '
                    'resume with --drop-optim-state for a fresh optimizer '
                    'state')
    hyper = [{k: v for k, v in g.items() if k != 'params'}
             for g in optimizer.param_groups]
    optimizer.load_state_dict(saved)
    for g, h in zip(optimizer.param_groups, hyper):
        g.update(h)


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None, *,
                    drop_optimizer: bool = False,
                    drop_layers: Optional[str] = None,
                    recount_epoch: bool = False) -> Tuple[int, int, float]:
    """Restore a `save_checkpoint` file into `model` leaf by leaf
    (`_merge_matching` with `drop_layers`) and, unless `drop_optimizer`,
    the optimizer state into `optimizer`: as the JAX package's
    `load_checkpoint`, a state saved over other parameters leaves the
    fresh one, and the step is restored. Where a restored moment does not
    fit its parameter (a head swap) the JAX step would fail on the shapes;
    this raises, naming `--drop-optim-state`. Returns (step, epoch,
    train_loss): step 0 with `drop_optimizer`, epoch 0 with
    `recount_epoch`."""
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    _merge_matching(model, ckpt['model'], drop_layers)
    step = int(ckpt['step'])
    if drop_optimizer:
        step = 0
    elif optimizer is not None and ckpt.get('optimizer') is not None:
        _restore_optimizer(path, optimizer, ckpt['optimizer'], model)
    epoch = 0 if recount_epoch else int(ckpt['epoch'])
    return step, epoch, float(ckpt['train_loss'])


def frozen_parameters(model: torch.nn.Module, regex: str) -> List[str]:
    """The names of `model`'s parameters that `--freeze regex` freezes: the
    JAX `freeze_mask` selection, a `re.search` over each parameter's flax
    path (`key_map`, collection `params`)."""
    pat = re.compile(regex)
    names = dict(model.named_parameters())
    return [tk for col, fk, tk, _, _ in key_map(model.cfg)
            if col == 'params' and tk in names and pat.search(fk)]
