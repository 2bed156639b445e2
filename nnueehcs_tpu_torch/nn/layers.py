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

In evaluation mode BatchNorm uses its running statistics and Dropout is
the identity. In training mode (``module.train()``) they follow the JAX
package: BatchNorm normalises with the batch mean and the biased batch
variance (centred first, then the mean of squares) over the batch axis
(-2) and moves its running statistics by an EMA that takes the unbiased
variance ``var * n / (n - 1)``; Dropout keeps a value with probability
``1 - p``, scales it by ``1 / (1 - p)`` and zeroes the rest with ``where``
(``p = 1`` gives exact zeros), drawing from the ``torch.Generator`` it is
given. The elementwise activations and ``LayerNorm`` follow the JAX package's
definitions (``LayerNorm`` normalises the last axis with the biased
variance and keeps ``weight``/``bias`` for the JAX ``scale``/``bias``).

Under a bf16 compute dtype (``Network.compute_dtype``) the activations
arrive in bf16 and the parameters stay fp32 master weights, as in the JAX
package: ``Linear`` casts its weight to the activation dtype, accumulates
the dot in fp32 (bf16 products are exact in fp32), adds the fp32 bias in
fp32 and returns the activation dtype; ``BatchNorm1d`` keeps its statistics
in fp32 (in training mode the batch mean and variance of the up-cast input,
and their EMA) but normalises in the activation dtype (each op rounds); the
activations and Dropout keep their input's dtype; ``LayerNorm`` multiplies
by its fp32 parameters, which promotes its output to fp32 as in JAX.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _lead(members):
    return () if members is None else (int(members),)


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
        if x.dtype != self.weight.dtype:
            # bf16 operands, fp32 accumulation, fp32 bias, activation dtype
            # out (the JAX Linear's preferred_element_type=float32)
            w = self.weight.to(x.dtype).float()
            y = torch.matmul(x.float(), w.transpose(-1, -2))
            if self.bias is not None:
                y = y + self.bias.unsqueeze(-2)
            return y.to(x.dtype)
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
        if self.training:
            # batch statistics and their EMA in fp32, from the up-cast input
            xf = x.float()
            mean = xf.mean(-2)
            c = xf - mean.unsqueeze(-2)
            var = (c * c).mean(-2)
            n = x.shape[-2]
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean.detach())
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * (var.detach() * (n / max(n - 1, 1))))
        else:
            mean, var = self.running_mean, self.running_var
        # statistics in fp32, the normalise in the activation dtype
        inv = torch.rsqrt(var + self.eps).to(x.dtype)
        y = (x - mean.to(x.dtype).unsqueeze(-2)) * inv.unsqueeze(-2)
        if self.affine:
            y = y * self.weight.to(x.dtype).unsqueeze(-2) \
                + self.bias.to(x.dtype).unsqueeze(-2)
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

    def forward(self, x, generator: torch.Generator = None):
        if not self.training or self.p <= 0.0:
            return x
        if generator is None:
            raise ValueError('Dropout in training mode draws from an explicit '
                             'torch.Generator; pass generator=')
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep,
                           torch.zeros((), dtype=x.dtype, device=x.device))


class Tanh(nn.Module):
    def __init__(self, members=None):
        super().__init__()

    def forward(self, x):
        return torch.tanh(x)


class Sigmoid(nn.Module):
    def __init__(self, members=None):
        super().__init__()

    def forward(self, x):
        return torch.sigmoid(x)


class GELU(nn.Module):
    """Exact (erf) GELU for ``approximate='none'``, the tanh form for any
    other value, as the JAX package reads the flag."""

    def __init__(self, approximate='none', members=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, approximate='none' if self.approximate == 'none'
                      else 'tanh')


class SiLU(nn.Module):
    def __init__(self, inplace=False, members=None):
        super().__init__()
        self.inplace = bool(inplace)   # accepted for schema parity, ignored

    def forward(self, x):
        return F.silu(x)


class ELU(nn.Module):
    def __init__(self, alpha=1.0, inplace=False, members=None):
        super().__init__()
        self.alpha = float(alpha)
        self.inplace = bool(inplace)

    def forward(self, x):
        return F.elu(x, alpha=self.alpha)


class LeakyReLU(nn.Module):
    def __init__(self, negative_slope=0.01, inplace=False, members=None):
        super().__init__()
        self.negative_slope = float(negative_slope)
        self.inplace = bool(inplace)

    def forward(self, x):
        return F.leaky_relu(x, negative_slope=self.negative_slope)


class Softplus(nn.Module):
    """``softplus(beta x) / beta``, and ``x`` itself where ``beta x`` exceeds
    ``threshold``."""

    def __init__(self, beta=1.0, threshold=20.0, members=None):
        super().__init__()
        self.beta = float(beta)
        self.threshold = float(threshold)

    def forward(self, x):
        return F.softplus(x, beta=self.beta, threshold=self.threshold)


class Identity(nn.Module):
    def __init__(self, members=None):
        super().__init__()

    def forward(self, x):
        return x


class LayerNorm(nn.Module):
    """``(x - mean) / sqrt(var + eps) * weight + bias`` over the last axis
    (biased variance), with ``weight``/``bias`` of ``normalized_shape`` (and
    a leading member axis with ``members``), as the JAX ``LayerNorm``."""

    def __init__(self, normalized_shape, eps=1e-5, members=None):
        super().__init__()
        shape = (int(normalized_shape),) if isinstance(normalized_shape, int) \
            else tuple(int(v) for v in normalized_shape)
        self.normalized_shape = shape
        self.eps = float(eps)
        self.members = members
        self.weight = nn.Parameter(torch.ones(_lead(members) + shape))
        self.bias = nn.Parameter(torch.zeros(_lead(members) + shape))

    def reset_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, correction=0)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        w, b = self.weight, self.bias
        if self.members is not None:   # (M, *shape) -> (M, 1, ..., *shape)
            lead = (w.shape[0],) + (1,) * (y.dim() - w.dim())
            w, b = w.reshape(lead + w.shape[1:]), b.reshape(lead + b.shape[1:])
        return y * w + b


# Names intentionally match torch.nn class names, as in the JAX registry.
LAYER_REGISTRY = {
    'Linear': Linear,
    'BatchNorm1d': BatchNorm1d,
    'ReLU': ReLU,
    'Dropout': Dropout,
    'Tanh': Tanh,
    'Sigmoid': Sigmoid,
    'GELU': GELU,
    'SiLU': SiLU,
    'ELU': ELU,
    'LeakyReLU': LeakyReLU,
    'Softplus': Softplus,
    'Identity': Identity,
    'LayerNorm': LayerNorm,
}
