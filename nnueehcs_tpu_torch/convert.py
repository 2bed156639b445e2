"""Arrays in the JAX package's layout <-> the port's modules.

The JAX package keeps a network's weights as two tuples with one entry per
layer: ``params`` (``Linear``: ``{'w': (in, out), 'b': (out,)}``,
``Conv2d``: ``{'w': (out, in, k, k), 'b': (out,)}``, the port's own OIHW
layout, ``BatchNorm1d``, ``BatchNorm2d`` and ``LayerNorm``: ``{'scale',
'bias'}``) and ``state`` (the BatchNorms: ``{'mean', 'var'}``), with a
leading member axis on every array for an ensemble. ``model.pth``
bundles store exactly these, as numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .nn.layers import BatchNorm1d, BatchNorm2d, Conv2d, LayerNorm, Linear

# port attribute -> (pytree, key) in the JAX layout
_LN_FIELDS = {'weight': ('params', 'scale'), 'bias': ('params', 'bias')}
_BN_FIELDS = {**_LN_FIELDS, 'running_mean': ('state', 'mean'),
              'running_var': ('state', 'var')}
_NORM_FIELDS = {BatchNorm1d: _BN_FIELDS, BatchNorm2d: _BN_FIELDS,
                LayerNorm: _LN_FIELDS}


def _copy(dst: torch.Tensor, src, what: str):
    if not isinstance(src, torch.Tensor):
        src = torch.tensor(np.asarray(src), dtype=dst.dtype)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f'{what}: expected shape {tuple(dst.shape)}, '
                         f'got {tuple(src.shape)}')
    dst.copy_(src)


def tensor_trees(net, values=None):
    """``(params, state)`` of ``net`` in the JAX layout as tensors on the
    net's device (views, no copies). ``values`` maps a parameter to the
    tensor to report in its place (an optimizer moment of its shape)."""
    def of(t):
        return t if values is None else values[t]
    params, state = [], []
    for layer in net.layers:
        p, s = {}, {}
        if isinstance(layer, (Linear, Conv2d)):
            p['w'] = of(layer.weight)
            if isinstance(layer, Linear):
                p['w'] = p['w'].transpose(-1, -2)
            if layer.bias is not None:
                p['b'] = of(layer.bias)
        elif type(layer) in _NORM_FIELDS:
            trees = {'params': p, 'state': s}
            for attr, (tree, key) in _NORM_FIELDS[type(layer)].items():
                t = getattr(layer, attr)
                if t is not None:
                    trees[tree][key] = of(t) if tree == 'params' else t
        params.append(p)
        state.append(s)
    return tuple(params), tuple(state)


def load_pytrees(net, params, state, values=None):
    """Copy JAX-layout ``params``/``state`` (numpy arrays or tensors; either
    may be None) into ``net``'s tensors in place, or with ``values`` into
    the tensors it maps the parameters to. The copies run under
    ``no_grad``, so each bumps the tensor's version: a write through
    ``.data`` would not, and caches keyed on versions would go stale."""
    for name, tree in (('params', params), ('state', state)):
        if tree is not None and len(tree) != len(net.layers):
            raise ValueError(f'{len(net.layers)} layers, but {len(tree)} '
                             f'{name} entries')
    dst_params, dst_state = tensor_trees(net, values)
    with torch.no_grad():
        for dst, src in ((dst_params, params), (dst_state, state)):
            if src is None:
                continue
            for i, (d_layer, s_layer) in enumerate(zip(dst, src)):
                for key, t in d_layer.items():
                    _copy(t, s_layer[key], f'layer {i} {key}')


def to_pytrees(net):
    """``(params, state)`` of ``net`` in the JAX layout, as numpy arrays."""
    def as_numpy(tree):
        return tuple({k: np.ascontiguousarray(t.detach().cpu().numpy())
                      for k, t in layer.items()} for layer in tree)
    params, state = tensor_trees(net)
    return as_numpy(params), as_numpy(state)
