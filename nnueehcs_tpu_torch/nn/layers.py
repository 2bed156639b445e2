"""Layers of the declarative network builder, as ``torch.nn`` modules.

Counterpart of ``nnueehcs_tpu/nn/layers.py``. Names match ``torch.nn``
class names so the architecture lists stored in configs and ``model.pth``
bundles load unchanged. Each layer with parameters takes ``members``: with
``members=M`` every parameter and buffer carries a leading member axis, and
an input ``(B, in)`` or ``(M, B, in)`` gives ``(M, B, out)``, so one module
stack evaluates a whole deep ensemble.

Layouts follow ``torch.nn``: ``Linear.weight`` is ``(out, in)`` where the
JAX package stores ``w`` as ``(in, out)``; ``BatchNorm1d`` keeps
``weight``/``bias`` (JAX ``scale``/``bias`` params) and
``running_mean``/``running_var`` (JAX ``mean``/``var`` state).
:mod:`nnueehcs_tpu_torch.convert` maps between the two.

Only evaluation is ported: BatchNorm uses its running statistics and
Dropout is the identity, and a module in training mode raises.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def _lead(members):
    return () if members is None else (int(members),)


def _eval_only(module):
    if module.training:
        raise NotImplementedError(
            f'{type(module).__name__}: only evaluation is ported; call .eval()')


class Linear(nn.Module):
    def __init__(self, in_features, out_features, bias=True, members=None):
        super().__init__()
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        lead = _lead(members)
        self.weight = nn.Parameter(torch.zeros(*lead, self.out_features,
                                               self.in_features))
        if bias:
            self.bias = nn.Parameter(torch.zeros(*lead, self.out_features))
        else:
            self.register_parameter('bias', None)

    def reset_parameters(self, generator: torch.Generator):
        """torch's default init, U(+-1/sqrt(in_features)), as in the JAX
        package."""
        bound = 1.0 / math.sqrt(self.in_features) if self.in_features else 0.0
        with torch.no_grad():
            for p in (self.weight, self.bias):
                if p is not None:
                    p.copy_(torch.rand(p.shape, generator=generator)
                            * (2 * bound) - bound)

    def forward(self, x):
        y = torch.matmul(x, self.weight.transpose(-1, -2))
        if self.bias is not None:
            y = y + self.bias.unsqueeze(-2)
        return y


class BatchNorm1d(nn.Module):
    def __init__(self, num_features, eps=1e-5, momentum=0.1, affine=True,
                 members=None):
        super().__init__()
        self.num_features = int(num_features)
        self.eps = float(eps)
        self.momentum = momentum
        self.affine = bool(affine)
        shape = _lead(members) + (self.num_features,)
        if self.affine:
            self.weight = nn.Parameter(torch.ones(shape))
            self.bias = nn.Parameter(torch.zeros(shape))
        else:
            self.register_parameter('weight', None)
            self.register_parameter('bias', None)
        self.register_buffer('running_mean', torch.zeros(shape))
        self.register_buffer('running_var', torch.ones(shape))

    def reset_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            self.running_mean.zero_()
            self.running_var.fill_(1.0)
            if self.affine:
                self.weight.fill_(1.0)
                self.bias.zero_()

    def forward(self, x):
        _eval_only(self)
        inv = torch.rsqrt(self.running_var + self.eps)
        y = (x - self.running_mean.unsqueeze(-2)) * inv.unsqueeze(-2)
        if self.affine:
            y = y * self.weight.unsqueeze(-2) + self.bias.unsqueeze(-2)
        return y


class ReLU(nn.Module):
    def __init__(self, inplace=False, members=None):
        super().__init__()
        self.inplace = bool(inplace)   # accepted for schema parity, ignored

    def forward(self, x):
        return torch.relu(x)


class Dropout(nn.Module):
    def __init__(self, p=0.5, members=None):
        super().__init__()
        self.p = float(p)

    def forward(self, x):
        _eval_only(self)
        return x


# Names intentionally match torch.nn class names, as in the JAX registry.
LAYER_REGISTRY = {
    'Linear': Linear,
    'BatchNorm1d': BatchNorm1d,
    'ReLU': ReLU,
    'Dropout': Dropout,
}
