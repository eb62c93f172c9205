"""Carry flax parameters across to the port's ``state_dict``.

The port's parameter names are the reference PyTorch ``state_dict`` keys,
the keys ``stmask_tpu/convert.py::map_torch_key`` reads.  This module
inverts that mapping: HWIO conv kernels become OIHW, Dense ``[in, out]``
kernels become ``[out, in]``, and FrozenBatchNorm ``scale/bias/mean/var``
become ``weight/bias/running_mean/running_var`` (plus the reference's
``num_batches_tracked``).  So a released reference checkpoint loads into
the port with plain ``load_state_dict``, and a flax tree converts with
``state_dict_from_flax``.  The same mapping carries a flax gradient (or
an updated parameter tree) onto the port's keys; ``include_bn=False``
leaves out the FrozenBatchNorm entries that are buffers in the port and
have no gradient: all of them under ``freeze_bn``, the running statistics
otherwise.  ``load_reference_weights`` overlays a reference-keyed ``.pth``
on a model's initial weights.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

# MakeNet conv names -> proto_net Sequential indices
_PROTO_IDX = {'conv0': 0, 'conv1': 2, 'conv2': 4, 'conv4': 8, 'conv5': 10}
_BN_NAMES = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
             'var': 'running_var'}


def _module_key(path: Tuple[str, ...]) -> Tuple[str, str]:
    """flax module path (without the leaf) -> (torch module key, kind);
    kind in {conv, bn, linear, align} (align: an FCB module, whose own leaf
    ``adaption_kernel`` is the deformable kernel)."""
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
        m = re.fullmatch(r'(conf|track|mask)_align_(\d+)', rest[0])
        if m:                 # FCB: FeatureAlign replaces the bank's conv
            bank = f'{head}.{m.group(1)}_layer.{m.group(2)}'
            if len(rest) == 1:
                return bank, 'align'
            if rest[1:] in (('conv_offset',), ('conv',)):
                return f'{bank}.{rest[1]}', 'conv'
    if top == 'temporal_net':
        kind = 'linear' if rest[0] in ('fc', 'fc_coeff') else 'conv'
        return f'TemporalNet.{rest[0]}', kind
    raise KeyError(f'no port parameter for flax module {"/".join(path)} '
                   '(the legacy head and the extra heads are not ported '
                   'yet)')


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_flax(params: Mapping, include_bn: bool = True,
                         freeze_bn: bool = True) -> Dict[str, torch.Tensor]:
    """flax param tree (``{'params': ...}`` or the bare tree; numpy or jax
    arrays) -> the port's ``state_dict`` (reference key names); with
    ``include_bn=False`` only the entries that are parameters in the port
    under ``cfg.freeze_bn == freeze_bn``."""
    if 'params' in params:
        params = params['params']
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        arr = np.asarray(leaf)
        key, kind = _module_key(path[:-1])
        name = path[-1]
        if kind == 'bn':
            if not include_bn and (freeze_bn or name in ('mean', 'var')):
                continue
            sd[f'{key}.{_BN_NAMES[name]}'] = torch.tensor(arr)
            if include_bn:
                sd[f'{key}.num_batches_tracked'] = torch.zeros(
                    (), dtype=torch.long)
            continue
        if kind == 'align' and name == 'adaption_kernel':
            arr = arr.transpose(3, 2, 0, 1)             # HWIO -> OIHW
            key, name = f'{key}.conv_adaption', 'weight'
        elif name == 'kernel':
            arr = arr.transpose(3, 2, 0, 1) if kind == 'conv' else arr.T
            name = 'weight'
        elif name != 'bias':
            raise KeyError(f'unexpected flax leaf {"/".join(path)}')
        sd[f'{key}.{name}'] = torch.tensor(np.ascontiguousarray(arr))
    return sd


def load_reference_weights(model: torch.nn.Module, path: str
                           ) -> Tuple[List[str], List[str]]:
    """Overlay a reference-keyed ``.pth`` (a bare ``state_dict``, or one
    under ``'state_dict'`` or the port's own ``'model'``) on ``model``'s
    current weights, in place, as the JAX package's
    ``load_torch_checkpoint`` + ``merge_params`` do (``convert.py:190,
    222``): a tensor the file lacks keeps its value, a key the model lacks
    is dropped, and a shape mismatch raises.  Returns (kept, dropped)."""
    saved = torch.load(path, map_location='cpu', weights_only=True)
    for wrapper in ('state_dict', 'model'):
        if wrapper in saved:
            saved = saved[wrapper]
            break
    own = model.state_dict()
    bad = [(k, tuple(v.shape), tuple(own[k].shape)) for k, v in saved.items()
           if k in own and v.shape != own[k].shape]
    if bad:
        raise ValueError(f'{path}: shape mismatches (file, model): {bad}')
    kept = [k for k in own if k not in saved]
    dropped = [k for k in saved if k not in own]
    model.load_state_dict({k: v for k, v in saved.items() if k in own},
                          strict=False)
    return kept, dropped
