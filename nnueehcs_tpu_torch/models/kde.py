"""KDE and kNN-KDE density-scored models, evaluation side.

Counterpart of ``nnueehcs_tpu/models/kde.py``. The prediction is the plain
MLP's; the uncertainty score is the negated density of the *input* under a
corpus fitted on training inputs (higher density, lower uncertainty):
``-exp(log density)`` of the exact Gaussian KDE
(:func:`~nnueehcs_tpu_torch.ops.kde.kde_logpdf`, the CUDA kernel on the
card) or ``-density`` of the kNN-truncated KDE
(:func:`~nnueehcs_tpu_torch.ops.kde.knn_kde_density`, an exact top-k in
tensor ops). Both scores have shape ``(N,)``. Far from the corpus the
density underflows and the score is 0 in float32, in both packages.

The corpus is fitted state: the trainer's hooks (``get_callbacks``) fit it
on the epoch-0 training inputs; ``fit_kde`` subsamples it with the JAX
package's ``default_rng(0)`` permutation, bundles carry it (``kde_data``,
``knn_fit_data``) and ``to(device)`` moves it with the network. A UE pass
before fitting raises ``ValueError('KDE not fitted yet')``; the prediction
alone needs no corpus.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..ops.kde import bandwidth_value, kde_logpdf, knn_kde_density
from ..training.hooks import KDEFitHook, KNNKDEFitHook
from .mlp import MLPModel


def _corpus(data, device):
    return torch.tensor(np.asarray(data), dtype=torch.float32, device=device)


def _subsample(data, train_fit_prop):
    """The first ``train_fit_prop`` of a ``default_rng(0)`` permutation of
    the rows, as the JAX package takes them."""
    data = np.asarray(data)
    take = int(train_fit_prop * len(data))
    return data[np.random.default_rng(0).permutation(len(data))[:take]]


class _FittedKDE:
    """Minimal stand-in for sklearn's fitted ``KernelDensity``: the corpus,
    ``bandwidth``, ``rtol``, the resolved ``bandwidth_`` and
    ``score_samples`` (log density)."""

    def __init__(self, data, bandwidth, rtol, device):
        self.data = _corpus(data, device)
        self.bandwidth = bandwidth
        self.rtol = rtol
        n, d = self.data.shape
        self.bandwidth_ = bandwidth_value(bandwidth, n, d)

    def to(self, device):
        self.data = self.data.to(device)
        return self

    def score_samples(self, x):
        return kde_logpdf(torch.as_tensor(x, dtype=torch.float32,
                                          device=self.data.device),
                          self.data, self.bandwidth_)


class KDEMLPModel(MLPModel):
    uq_method = 'kde'

    def __init__(self, net, bandwidth: Union[str, float] = 'scott',
                 rtol: float = 0.1, train_fit_prop: float = 1.0, **kwargs):
        super().__init__(net, **kwargs)
        self.bandwidth = bandwidth
        self.rtol = rtol / 10000           # reference scaling, undone below
        self.kde: Optional[_FittedKDE] = None
        self.train_fit_prop = train_fit_prop

    def fit_kde(self, data):
        self.kde = _FittedKDE(_subsample(data, self.train_fit_prop),
                              self.bandwidth, self.rtol, self.device)

    def to(self, device):
        super().to(device)
        if self.kde is not None:
            self.kde.to(self.device)
        return self

    def eval_output(self, x, return_ue: bool = False):
        pred = self.net(x)
        if not return_ue:
            return pred
        if self.kde is None:
            raise ValueError('KDE not fitted yet')
        # negated so that a higher density gives a lower uncertainty
        return pred, -torch.exp(self.kde.score_samples(x))

    def get_callbacks(self):
        return [KDEFitHook()]

    def config_dict(self):
        d = super().config_dict()
        d['bandwidth'] = self.bandwidth
        d['rtol'] = self.rtol * 10000
        d['train_fit_prop'] = self.train_fit_prop
        return d

    def _extra_arrays(self):
        return {'kde_data': None if self.kde is None
                else self.kde.data.cpu().numpy()}

    def _load_extra_arrays(self, arrays):
        data = arrays.get('kde_data')
        if data is not None:
            self.kde = _FittedKDE(data, self.bandwidth, self.rtol, self.device)


class KNNKDEMLPModel(MLPModel):
    uq_method = 'knn_kde'

    def __init__(self, net, bandwidth: Union[str, float] = 'scott',
                 k: int = 10, train_fit_prop: float = 1.0, knn_exact='auto',
                 **kwargs):
        super().__init__(net, **kwargs)
        self.bandwidth = bandwidth
        self.k = k
        self.train_fit_prop = train_fit_prop
        # the JAX package's exactness setting (True, False or 'auto'); kept
        # for bundles only: the port always runs the exact top-k
        self.knn_exact = knn_exact
        self._fit_data = None
        self._bandwidth_value = None

    def _install(self, data):
        self._fit_data = _corpus(data, self.device)
        n, d = self._fit_data.shape
        self._bandwidth_value = bandwidth_value(self.bandwidth, n, d)

    def fit_kde(self, data):
        self._install(_subsample(data, self.train_fit_prop))

    def to(self, device):
        super().to(device)
        if self._fit_data is not None:
            self._fit_data = self._fit_data.to(self.device)
        return self

    def eval_output(self, x, return_ue: bool = False):
        pred = self.net(x)
        if not return_ue:
            return pred
        if self._fit_data is None:
            raise ValueError('KDE not fitted yet')
        return pred, -knn_kde_density(x, self._fit_data,
                                      self._bandwidth_value, self.k)

    def get_callbacks(self):
        return [KNNKDEFitHook()]

    def config_dict(self):
        d = super().config_dict()
        d['bandwidth'] = self.bandwidth
        d['k'] = self.k
        d['train_fit_prop'] = self.train_fit_prop
        d['knn_exact'] = self.knn_exact
        return d

    def _extra_arrays(self):
        return {'knn_fit_data': None if self._fit_data is None
                else self._fit_data.cpu().numpy()}

    def _load_extra_arrays(self, arrays):
        data = arrays.get('knn_fit_data')
        if data is not None:
            # subsampled at fit time: installed as it is
            self._install(data)
