"""Architecture list -> sequential ``torch.nn`` network.

Counterpart of ``nnueehcs_tpu/nn/network.py``. The schema is the one stored
in configs and ``model.pth`` bundles, a list of single-key dicts::

    [{'Linear': {'args': [5, 128]}}, {'BatchNorm1d': {'args': [128]}},
     {'ReLU': {'inplace': True}}, ...]
"""
from __future__ import annotations

import copy
from typing import Optional, Sequence

import torch
from torch import nn

from .layers import LAYER_REGISTRY, Dropout


class LayerBuilder:
    """Name -> layer-class lookup over a chain of namespaces. Construction
    failures are re-raised with the layer name and arguments attached, as
    in the JAX package."""

    def __init__(self, *namespaces):
        self._namespaces = list(namespaces) if namespaces else [LAYER_REGISTRY]

    def __call__(self, name: str, *args, **kwargs):
        cls = next((ns[name] for ns in self._namespaces if name in ns), None)
        if cls is None:
            raise KeyError(f'Unknown layer type: {name!r}', name, args, kwargs)
        try:
            return cls(*args, **kwargs)
        except Exception as e:  # re-wrap with context, like the JAX builder
            raise e.__class__(str(e), name, args, kwargs) from e


class Network(nn.Module):
    """A sequential stack of layers, built in evaluation mode. With
    ``members=M`` every layer's parameters carry a leading member axis and
    ``forward`` returns ``(M, B, out)``. In training mode ``generator``
    feeds the Dropout layers. ``compute_dtype`` (None, or
    ``torch.bfloat16``; set by the model's ``set_precision``) is the dtype
    of the activations: a floating input of another dtype is cast to it on
    entry and the output back to the input's dtype on exit, while the
    parameters stay fp32."""

    def __init__(self, layers: Sequence[nn.Module],
                 architecture: Optional[list] = None, members=None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.architecture = copy.deepcopy(architecture)
        self.members = members
        self.compute_dtype = None
        self.eval()

    def reset_parameters(self, generator: torch.Generator):
        for layer in self.layers:
            if hasattr(layer, 'reset_parameters'):
                layer.reset_parameters(generator)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        cd = self.compute_dtype
        out_dtype = None
        if cd is not None and x.is_floating_point() and x.dtype != cd:
            out_dtype = x.dtype
            x = x.to(cd)
        for layer in self.layers:
            x = layer(x, generator) if isinstance(layer, Dropout) else layer(x)
        return x if out_dtype is None else x.to(out_dtype)


def build_network(architecture: list, builder: Optional[LayerBuilder] = None,
                  members=None) -> Network:
    """Architecture list -> :class:`Network`. ``None`` bodies are empty
    kwargs, as in the JAX builder."""
    if builder is None:
        builder = LayerBuilder(LAYER_REGISTRY)
    layers = []
    for block in copy.deepcopy(architecture):
        if len(block) != 1:
            raise ValueError(f'each layer block needs exactly one key: {block}')
        name, kwargs = next(iter(block.items()))
        kwargs = dict(kwargs or {})
        args = kwargs.pop('args', [])
        layers.append(builder(name, *args, members=members, **kwargs))
    return Network(layers, architecture=architecture, members=members)
