"""Weights carried across from the JAX package or a reference checkpoint.

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

from typing import Dict, List, Tuple

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
