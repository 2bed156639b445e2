"""Layers of the declarative network builder, as ``torch.nn`` modules.

Counterpart of ``nnueehcs_tpu/nn/layers.py``. Names match ``torch.nn``
class names so the architecture lists stored in configs and ``model.pth``
bundles load unchanged. Each layer with parameters takes ``members``: with
``members=M`` every parameter and buffer carries a leading member axis, and
an input ``(B, in)`` or ``(M, B, in)`` gives ``(M, B, out)``, so one module
stack evaluates a whole deep ensemble. The CNN layers take NCHW images:
``Conv2d`` maps ``(B, C, H, W)`` or ``(M, B, C, H, W)`` to ``(M, B, O, H',
W')`` in one convolution call, ``BatchNorm2d`` normalises per channel,
the pools and ``Flatten`` carry a member axis in front through.

Layouts follow ``torch.nn``: ``Linear.weight`` is ``(out, in)`` where the
JAX package stores ``w`` as ``(in, out)``; ``Conv2d.weight`` is OIHW in
both packages; ``BatchNorm1d`` and ``BatchNorm2d`` keep
``weight``/``bias`` (JAX ``scale``/``bias`` params) and
``running_mean``/``running_var`` (JAX ``mean``/``var`` state).
:mod:`nnueehcs_tpu_torch.convert` maps between the two.

In evaluation mode BatchNorm uses its running statistics and Dropout is
the identity. In training mode (``module.train()``) they follow the JAX
package: BatchNorm normalises with the batch mean and the biased batch
variance (centred first, then the mean of squares) over the batch axis
(-2; for ``BatchNorm2d`` the batch and image axes, n = B H W) and moves
its running statistics by an EMA that takes the unbiased variance
``var * n / (n - 1)``; Dropout keeps a value with probability ``1 - p``,
scales it by ``1 / (1 - p)`` and zeroes the rest with ``where``
(``p = 1`` gives exact zeros), drawing from the ``torch.Generator`` it is
given. When a training step's batch is split over ranks
(:mod:`nnueehcs_tpu_torch.training.sharded`), a BatchNorm's
``batch_reduce`` sums its batch moments over the ranks (differentiably),
so the statistics are the global batch's, and a Dropout draws the global
batch's mask and keeps its rows. The elementwise activations and ``LayerNorm`` follow the JAX package's
definitions (``LayerNorm`` normalises the last axis with the biased
variance and keeps ``weight``/``bias`` for the JAX ``scale``/``bias``).

Under a bf16 compute dtype (``Network.compute_dtype``) the activations
arrive in bf16 and the parameters stay fp32 master weights, as in the JAX
package: ``Linear`` and ``Conv2d`` cast their weight to the activation
dtype, accumulate the products in fp32 (bf16 products are exact in fp32),
add the fp32 bias in fp32 and return the activation dtype; an fp32
``Conv2d`` on the card runs in full fp32, not TF32; the BatchNorms keep
their statistics in fp32 (in training mode the batch mean and variance of
the up-cast input, and their EMA) but normalise in the activation dtype
(each op rounds); the activations, the pools and Dropout keep their
input's dtype; ``LayerNorm`` multiplies
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


def _true_fp32_conv2d(x, w, stride, padding, groups=1):
    """``F.conv2d`` without bias. On the card cuDNN may run an fp32
    convolution in TF32 (``torch.backends.cudnn.allow_tf32`` is True by
    default); here it runs in full fp32, as a Linear's matmul does."""
    if x.device.type != 'cuda':
        return F.conv2d(x, w, stride=stride, padding=padding, groups=groups)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        return F.conv2d(x, w, stride=stride, padding=padding, groups=groups)


class Conv2d(nn.Module):
    """A 2-D convolution over NCHW images, weight ``(out, in, k, k)``
    (OIHW, as the JAX package stores it). With ``members=M`` an input
    ``(B, C, H, W)`` or ``(M, B, C, H, W)`` gives ``(M, B, O, H', W')``,
    one convolution call over every member (grouped by member for a
    stacked input)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, bias=True, members=None):
        super().__init__()
        self.in_channels = int(in_channels)
        self.out_channels = int(out_channels)
        self.kernel_size = int(kernel_size)
        self.stride = int(stride)
        self.padding = int(padding)
        k = self.kernel_size
        lead = _lead(members)
        self.weight = nn.Parameter(torch.zeros(
            *lead, self.out_channels, self.in_channels, k, k))
        if bias:
            self.bias = nn.Parameter(torch.zeros(*lead, self.out_channels))
        else:
            self.register_parameter('bias', None)

    def reset_parameters(self, generator: torch.Generator):
        """torch's default init, U(+-1/sqrt(in_channels k^2)), as in the
        JAX package."""
        fan_in = self.in_channels * self.kernel_size ** 2
        bound = 1.0 / math.sqrt(fan_in) if fan_in else 0.0
        with torch.no_grad():
            for p in (self.weight, self.bias):
                if p is not None:
                    p.copy_(torch.rand(p.shape, generator=generator)
                            * (2 * bound) - bound)

    def forward(self, x):
        w, b = self.weight, self.bias
        bf16 = x.dtype != w.dtype
        if bf16:
            # bf16 operands, fp32 accumulation, fp32 bias, activation
            # dtype out (the JAX Conv2d's preferred_element_type=float32)
            w = w.to(x.dtype)
            out_dtype, x, w = x.dtype, x.float(), w.float()
        if w.dim() == 4:
            y = _true_fp32_conv2d(x, w, self.stride, self.padding)
            if b is not None:
                y = y + b[:, None, None]
        else:
            M = w.shape[0]
            flat_w = w.reshape((-1,) + w.shape[2:])          # (M*O, C, k, k)
            if x.dim() == 4:         # every member sees the same images
                y = _true_fp32_conv2d(x, flat_w, self.stride, self.padding)
            else:                    # (M, B, C, H, W): member m's own images
                B = x.shape[1]
                y = _true_fp32_conv2d(
                    x.transpose(0, 1).reshape((B, -1) + x.shape[3:]),
                    flat_w, self.stride, self.padding, groups=M)
            y = y.reshape((y.shape[0], M, -1) + y.shape[2:]).transpose(0, 1)
            if b is not None:
                y = y + b[:, None, :, None, None]
        return y.to(out_dtype) if bf16 else y


def _per_channel(t):
    """A ``(C,)`` or, with a member axis, ``(M, C)`` statistic or
    parameter viewed against NCHW activations: ``(C, 1, 1)`` or ``(M, 1,
    C, 1, 1)``."""
    t = t[..., None, None]
    return t if t.dim() == 3 else t.unsqueeze(1)


class _BatchNorm(nn.Module):
    """The parameters and buffers of a BatchNorm, ``(C,)`` each or ``(M,
    C)`` with a member axis."""

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
        # the batch split over ranks: sums over them (training/sharded.py)
        self.batch_reduce = None

    def _batch_mean(self, t, dims):
        """The mean of ``t`` over the batch axes ``dims``: of this rank's
        rows, or of the global batch when the batch is split."""
        if self.batch_reduce is None:
            return t.mean(dims)
        return self.batch_reduce.mean(t, dims)

    def _batch_count(self, x, dims) -> int:
        n = math.prod(x.shape[d] for d in dims)
        return n if self.batch_reduce is None else self.batch_reduce.count(n)

    def reset_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            self.running_mean.zero_()
            self.running_var.fill_(1.0)
            if self.affine:
                self.weight.fill_(1.0)
                self.bias.zero_()


class BatchNorm1d(_BatchNorm):
    def forward(self, x):
        if self.training:
            # batch statistics and their EMA in fp32, from the up-cast input
            xf = x.float()
            mean = self._batch_mean(xf, (-2,))
            c = xf - mean.unsqueeze(-2)
            var = self._batch_mean(c * c, (-2,))
            n = self._batch_count(x, (-2,))
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


class BatchNorm2d(_BatchNorm):
    """Per-channel BatchNorm over NCHW activations ``(B, C, H, W)`` or,
    with a member axis, ``(M, B, C, H, W)``: in training mode the
    statistics reduce over the batch and the image (n = B H W), never
    over members; the rest is :class:`BatchNorm1d`'s."""

    def forward(self, x):
        ch = _per_channel
        if self.training:
            # batch statistics and their EMA in fp32, from the up-cast input
            xf = x.float()
            dims = (-4, -2, -1)
            mean = self._batch_mean(xf, dims)
            c = xf - ch(mean)
            var = self._batch_mean(c * c, dims)
            n = self._batch_count(x, dims)
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean.detach())
                unbiased = var.detach() * (n / max(n - 1, 1))
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * unbiased)
            mean, var = ch(mean), ch(var)
        else:
            mean, var = ch(self.running_mean), ch(self.running_var)
        # statistics in fp32, the normalise in the activation dtype
        inv = torch.rsqrt(var + self.eps).to(x.dtype)
        y = (x - mean.to(x.dtype)) * inv
        if self.affine:
            y = y * ch(self.weight).to(x.dtype) + ch(self.bias).to(x.dtype)
        return y


class Flatten(nn.Module):
    """``x.reshape(x.shape[:s] + (-1,) + x.shape[e + 1:])`` for ``s =
    start_dim`` and ``e = end_dim``, dims counted from the batch axis: on
    an activation that carries a member axis in front (``stacked``) both
    move one place on."""

    def __init__(self, start_dim=1, end_dim=-1, members=None):
        super().__init__()
        self.start_dim = int(start_dim)
        self.end_dim = int(end_dim)

    def forward(self, x, stacked: bool = False):
        s = self.start_dim + int(stacked)
        end = self.end_dim + int(stacked) if self.end_dim >= 0 \
            else x.dim() + self.end_dim
        return x.reshape(x.shape[:s] + (-1,) + x.shape[end + 1:])


class _Pool2d(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, members=None):
        super().__init__()
        self.kernel_size = int(kernel_size)
        self.stride = self.kernel_size if stride is None else int(stride)
        self.padding = int(padding)

    def _pool(self, x):
        raise NotImplementedError

    def _padded(self, x, value):
        """``x`` padded on both sides of H and W with ``value``: pooled
        then with no padding of torch's, which refuses any wider than half
        the window, where JAX pads as far as asked."""
        p = self.padding
        return F.pad(x, (p, p, p, p), value=value) if p else x

    def forward(self, x):
        lead = x.shape[:-3]
        y = self._pool(x.reshape((-1,) + x.shape[-3:]))
        return y.reshape(lead + y.shape[1:])


class MaxPool2d(_Pool2d):
    """Max over ``k x k`` windows (stride ``kernel_size`` unless given),
    the padding -inf, over the last two axes of NCHW activations (with or
    without a member axis in front). A window wholly in the padding gives
    -inf, as the JAX package's ``reduce_window`` does."""

    def _pool(self, x):
        return F.max_pool2d(self._padded(x, float('-inf')),
                            self.kernel_size, self.stride)


class AvgPool2d(_Pool2d):
    """The mean of ``k x k`` windows, padded zeros counted: the window's
    sum over ``k^2``, as the JAX package divides. A bf16 activation's
    window is summed in fp32 and rounded once, where the JAX package's
    ``reduce_window`` rounds each partial sum."""

    def _pool(self, x):
        return F.avg_pool2d(self._padded(x, 0.0), self.kernel_size,
                            self.stride)


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

    def forward(self, x, generator: torch.Generator = None, rows=None):
        """``rows``, for a batch split over ranks: ``(batch axis, global
        rows, this rank's row indices, global members, first member)``; the
        mask is drawn for the global batch (and every member) and this
        rank's part kept, so the split changes no mask."""
        if not self.training or self.p <= 0.0:
            return x
        if generator is None:
            raise ValueError('Dropout in training mode draws from an explicit '
                             'torch.Generator; pass generator=')
        keep = 1.0 - self.p
        if rows is None:
            mask = torch.rand(x.shape, generator=generator,
                              device=x.device) < keep
        else:
            axis, total, index, members, first = rows
            shape = list(x.shape)
            shape[axis] = total
            if axis == 1:
                shape[0] = members
            mask = torch.rand(shape, generator=generator,
                              device=x.device) < keep
            mask = mask.index_select(axis, index)
            if axis == 1:
                mask = mask[first:first + x.shape[0]]
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
    'Conv2d': Conv2d,
    'BatchNorm1d': BatchNorm1d,
    'BatchNorm2d': BatchNorm2d,
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
    'Flatten': Flatten,
    'MaxPool2d': MaxPool2d,
    'AvgPool2d': AvgPool2d,
}


def register_layer(name: str, cls) -> None:
    """Make ``cls`` buildable under ``name`` in architecture lists (the
    JAX package's extension hook). Its constructor must take
    ``members=``."""
    LAYER_REGISTRY[name] = cls
