"""Mean-variance estimation (heteroscedastic Gaussian head), evaluation side.

Counterpart of ``nnueehcs_tpu/models/mve.py``. The network's last layer
emits ``(mu, raw)``; the prediction is ``mu`` and the uncertainty estimate
is ``sigma = sqrt(softplus(raw) + min_variance)``, both ``(N, 1)``, from
one pass through the modules (no kernel in either package). Training and
validation minimise :func:`gaussian_nll`, whatever loss the configuration
names, with its variance floor ``_VAR_EPS`` kept apart from the bundle's
``min_variance``, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .base import WrappedModelBase

_VAR_EPS = 1e-6


def gaussian_nll(out, y):
    """Mean Gaussian negative log-likelihood (without the constant) of
    ``y`` under ``out[..., 0:1]`` = mu and ``out[..., 1:2]`` = the raw
    variance parameter."""
    mu = out[..., 0:1]
    var = F.softplus(out[..., 1:2]) + _VAR_EPS
    return torch.mean(0.5 * torch.log(var) + 0.5 * torch.square(y - mu) / var)


class MVEMLPModel(WrappedModelBase):
    uq_method = 'mve'

    def __init__(self, net, min_variance: float = _VAR_EPS, **kwargs):
        super().__init__(net, **kwargs)
        self.min_variance = min_variance

    def training_loss(self, batch, generator=None):
        x, y = batch
        return gaussian_nll(self.net(x, generator), y)

    def validation_loss(self, batch, seed: int = 0):
        x, y = batch
        with torch.no_grad():
            return gaussian_nll(self.net(x), y)

    def eval_output(self, x, return_ue: bool = False):
        out = self.net(x)
        mu = out[..., 0:1]
        if not return_ue:
            return mu
        return mu, torch.sqrt(F.softplus(out[..., 1:2]) + self.min_variance)

    def config_dict(self):
        d = super().config_dict()
        d['min_variance'] = self.min_variance
        return d
