"""Loss registry keyed by ``torch.nn.functional`` names.

Counterpart of ``nnueehcs_tpu/ops/losses.py``: the same names and the same
reduction (the mean over all elements). ``l1_loss`` differentiates as the
JAX package's ``jnp.abs`` does, with gradient +1 where the difference is
exactly 0 (torch's ``abs`` gives 0 there, and a training run from the same
init would drift apart). The MVE Gaussian NLL is
:func:`nnueehcs_tpu_torch.models.mve.gaussian_nll`, outside the registry as
in the JAX package.
"""
from __future__ import annotations

import torch


class _Abs(torch.autograd.Function):
    """``|x|`` with gradient ``+1`` at 0, as ``jax.grad(jnp.abs)``."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.abs()

    @staticmethod
    def backward(ctx, grad):
        x, = ctx.saved_tensors
        return torch.where(x >= 0, grad, -grad)


def l1_loss(pred, target):
    return torch.mean(_Abs.apply(pred - target))


def mse_loss(pred, target):
    return torch.mean(torch.square(pred - target))


def smooth_l1_loss(pred, target, beta: float = 1.0):
    d = _Abs.apply(pred - target)
    return torch.mean(torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta))


def huber_loss(pred, target, delta: float = 1.0):
    d = _Abs.apply(pred - target)
    return torch.mean(torch.where(d <= delta, 0.5 * d * d,
                                  delta * (d - 0.5 * delta)))


def binary_cross_entropy(pred, target):
    # the log terms clamped at -100, as torch and the JAX package do
    logp = torch.clamp(torch.log(pred), -100.0, 0.0)
    log1mp = torch.clamp(torch.log1p(-pred), -100.0, 0.0)
    return -torch.mean(target * logp + (1 - target) * log1mp)


def binary_cross_entropy_with_logits(logits, target):
    return torch.mean(torch.clamp(logits, min=0) - logits * target
                      + torch.log1p(torch.exp(-logits.abs())))


def cross_entropy(logits, target):
    logp = torch.log_softmax(logits, dim=-1)
    if target.dim() == logits.dim():           # soft labels
        return -torch.mean(torch.sum(target * logp, dim=-1))
    return -torch.mean(torch.gather(logp, -1, target[..., None].long()))


LOSS_REGISTRY = {
    'l1_loss': l1_loss,
    'mse_loss': mse_loss,
    'smooth_l1_loss': smooth_l1_loss,
    'huber_loss': huber_loss,
    'binary_cross_entropy': binary_cross_entropy,
    'binary_cross_entropy_with_logits': binary_cross_entropy_with_logits,
    'cross_entropy': cross_entropy,
}


def get_loss_fn(name: str):
    try:
        return LOSS_REGISTRY[name]
    except KeyError:
        raise ValueError(f'Unknown loss function: {name}') from None
