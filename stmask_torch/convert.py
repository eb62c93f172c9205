"""Carry flax parameters across to the port's ``state_dict``.

The port's parameter names are the reference PyTorch ``state_dict`` keys,
the keys ``stmask_tpu/convert.py::map_torch_key`` reads.  This module
inverts that mapping: HWIO conv kernels become OIHW, Dense ``[in, out]``
kernels become ``[out, in]``, and FrozenBatchNorm ``scale/bias/mean/var``
become ``weight/bias/running_mean/running_var`` (plus the reference's
``num_batches_tracked``).  So a released reference checkpoint loads into
the port with plain ``load_state_dict``, and a flax tree converts with
``state_dict_from_flax``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

# MakeNet conv names -> proto_net Sequential indices
_PROTO_IDX = {'conv0': 0, 'conv1': 2, 'conv2': 4, 'conv4': 8, 'conv5': 10}
_BN_NAMES = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
             'var': 'running_var'}


def _module_key(path: Tuple[str, ...]) -> Tuple[str, str]:
    """flax module path (without the leaf) -> (torch module key, kind);
    kind in {conv, bn, linear}."""
    top, rest = path[0], path[1:]
    if top == 'backbone':
        if rest[0] in ('conv1', 'bn1'):
            return f'backbone.{rest[0]}', 'bn' if rest[0] == 'bn1' else 'conv'
        m = re.fullmatch(r'layer(\d+)_(\d+)', rest[0])
        if m:
            blk = f'backbone.layers.{m.group(1)}.{m.group(2)}'
            sub = rest[1:]
            if sub[0] == 'downsample_conv':
                return f'{blk}.downsample.0', 'conv'
            if sub[0] == 'downsample_bn':
                return f'{blk}.downsample.1', 'bn'
            kind = 'bn' if sub[0].startswith('bn') else 'conv'
            return '.'.join((blk,) + sub), kind
    if top == 'fpn':
        m = re.fullmatch(r'(lat|pred|downsample)_(\d+)', rest[0])
        if m:
            return f'fpn.{m.group(1)}_layers.{m.group(2)}', 'conv'
    if top == 'proto_net' and rest[0] in _PROTO_IDX:
        return f'proto_net.{_PROTO_IDX[rest[0]]}', 'conv'
    if top == 'prediction_head':
        head = 'prediction_layers.0'
        if rest[0] == 'upfeature':
            return f'{head}.upfeature.0', 'conv'
        m = re.fullmatch(r'(conf|bbox|track|mask)_extra_(\d+)', rest[0])
        if m:
            return f'{head}.{m.group(1)}_extra.{2 * int(m.group(2))}', 'conv'
        m = re.fullmatch(r'(conf|bbox|track|mask|centerness)_layer_(\d+)',
                         rest[0])
        if m:
            return f'{head}.{m.group(1)}_layer.{m.group(2)}', 'conv'
    if top == 'temporal_net':
        kind = 'linear' if rest[0] in ('fc', 'fc_coeff') else 'conv'
        return f'TemporalNet.{rest[0]}', kind
    raise KeyError(f'no port parameter for flax module {"/".join(path)} '
                   '(FCB, the legacy head and the extra heads are not '
                   'ported yet)')


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax param tree (``{'params': ...}`` or the bare tree; numpy or jax
    arrays) -> the port's ``state_dict`` (reference key names)."""
    if 'params' in params:
        params = params['params']
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        arr = np.asarray(leaf)
        key, kind = _module_key(path[:-1])
        name = path[-1]
        if kind == 'bn':
            sd[f'{key}.{_BN_NAMES[name]}'] = torch.tensor(arr)
            sd[f'{key}.num_batches_tracked'] = torch.zeros((),
                                                           dtype=torch.long)
            continue
        if name == 'kernel':
            arr = arr.transpose(3, 2, 0, 1) if kind == 'conv' else arr.T
            name = 'weight'
        elif name != 'bias':
            raise KeyError(f'unexpected flax leaf {"/".join(path)}')
        sd[f'{key}.{name}'] = torch.tensor(np.ascontiguousarray(arr))
    return sd
