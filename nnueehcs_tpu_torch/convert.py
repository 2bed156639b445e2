"""Arrays in the JAX package's layout <-> the port's modules.

The JAX package keeps a network's weights as two tuples with one entry per
layer: ``params`` (``Linear``: ``{'w': (in, out), 'b': (out,)}``,
``BatchNorm1d`` and ``LayerNorm``: ``{'scale', 'bias'}``) and ``state``
(``BatchNorm1d``: ``{'mean', 'var'}``), with a leading member axis on every
array for an ensemble. ``model.pth`` bundles store exactly these, as numpy
arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .nn.layers import BatchNorm1d, LayerNorm, Linear

# port attribute -> (pytree, key) in the JAX layout
_LN_FIELDS = {'weight': ('params', 'scale'), 'bias': ('params', 'bias')}
_NORM_FIELDS = {
    BatchNorm1d: {**_LN_FIELDS, 'running_mean': ('state', 'mean'),
                  'running_var': ('state', 'var')},
    LayerNorm: _LN_FIELDS,
}


def _copy(dst: torch.Tensor, src, what: str):
    src = torch.tensor(np.asarray(src), dtype=dst.dtype)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f'{what}: expected shape {tuple(dst.shape)}, '
                         f'got {tuple(src.shape)}')
    dst.copy_(src)


def load_pytrees(net, params, state):
    """Copy JAX-layout ``params``/``state`` into ``net``'s tensors in place."""
    if len(params) != len(net.layers) or len(state) != len(net.layers):
        raise ValueError(f'{len(net.layers)} layers, but {len(params)} params '
                         f'and {len(state)} state entries')
    with torch.no_grad():
        for i, layer in enumerate(net.layers):
            trees = {'params': params[i], 'state': state[i]}
            if isinstance(layer, Linear):
                _copy(layer.weight, np.swapaxes(np.asarray(params[i]['w']),
                                                -1, -2), f'layer {i} w')
                if layer.bias is not None:
                    _copy(layer.bias, params[i]['b'], f'layer {i} b')
            elif type(layer) in _NORM_FIELDS:
                for attr, (tree, key) in _NORM_FIELDS[type(layer)].items():
                    if getattr(layer, attr) is not None:
                        _copy(getattr(layer, attr), trees[tree][key],
                              f'layer {i} {key}')


def to_pytrees(net):
    """``(params, state)`` of ``net`` in the JAX layout, as numpy arrays."""
    params, state = [], []
    for layer in net.layers:
        p, s = {}, {}
        if isinstance(layer, Linear):
            p['w'] = np.ascontiguousarray(np.swapaxes(
                layer.weight.detach().cpu().numpy(), -1, -2))
            if layer.bias is not None:
                p['b'] = layer.bias.detach().cpu().numpy()
        elif type(layer) in _NORM_FIELDS:
            trees = {'params': p, 'state': s}
            for attr, (tree, key) in _NORM_FIELDS[type(layer)].items():
                t = getattr(layer, attr)
                if t is not None:
                    trees[tree][key] = t.detach().cpu().numpy()
        params.append(p)
        state.append(s)
    return tuple(params), tuple(state)
