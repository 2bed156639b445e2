"""PAGER: Δ-UQ anchoring plus a conformal anchoring-error score.

Counterpart of ``nnueehcs_tpu/models/pager.py``. The Δ-UQ mean and spread
come from :class:`~nnueehcs_tpu_torch.models.delta_uq.DeltaUQMLP` (the fused
kernel on the card). The score of a sample ``s`` uses the ``(B, A)``
prediction matrix, whose entry ``(s, a)`` is the prediction for anchor
input ``a`` when the network is anchored at ``s``:
``score(s) = max_a |P[s, a] - anchors_Y[a]|``, and the uncertainty is
``max(spread, score)``. The matrix is plain tensor work through the
modules, chunked so at most the rows budget of anchored rows is in flight,
as the JAX package computes it outside any kernel. Training is Δ-UQ's; the
anchor hook also keeps the anchors' targets (``anchors_Y``).
"""
from __future__ import annotations

import torch

from ..training.hooks import PAGERGetAnchorsHook
from .delta_uq import DeltaUQMLP, anchored_input


class PAGERMLP(DeltaUQMLP):
    uq_method = 'pager'

    def __init__(self, net, estimator: str = 'std', anchored_batch_size=None,
                 num_anchors: int = 5, vectorize: bool = True, **kwargs):
        super().__init__(net, estimator=estimator, num_anchors=num_anchors,
                         anchored_batch_size=anchored_batch_size, **kwargs)
        self.vectorize = vectorize
        self._anchors_Y = None

    @property
    def anchors_Y(self):
        return self._anchors_Y

    @anchors_Y.setter
    def anchors_Y(self, value):
        self._anchors_Y = self._as_buffer(value)

    def get_callbacks(self):
        return [PAGERGetAnchorsHook()]

    def to(self, device):
        super().to(device)
        if self._anchors_Y is not None:
            self._anchors_Y = self._anchors_Y.to(self.device)
        return self

    def prediction_matrix(self, x, anchors_x):
        """``(B, A)``: the first output for each anchor input while the
        network is anchored at each row of ``x``."""
        rows, count = x.shape[0], anchors_x.shape[0]
        g = max(1, min(rows, self._rows_budget(x) // max(count, 1)))
        out = []
        for start in range(0, rows, g):
            s = x[start:start + g]
            inp = anchored_input(
                anchors_x.unsqueeze(0).expand((s.shape[0],) + anchors_x.shape),
                s.unsqueeze(1).expand((-1, count) + s.shape[1:]))
            p = self.net(inp.reshape((-1,) + inp.shape[2:]))
            out.append(p.reshape(s.shape[0], count, -1)[..., 0])
        return torch.cat(out)

    def eval_output(self, x, return_ue: bool = False):
        anchors = self._require_anchors()
        if self._anchors_Y is None:
            raise ValueError('PAGER anchors are set but anchors_Y is not; '
                             'conformal scores need both')
        mean, spread = self._anchored_stats(x, anchors, self.num_anchors)
        if not return_ue:
            return mean
        p = self.prediction_matrix(x, anchors[:self.num_anchors])
        y = self._anchors_Y[:self.num_anchors].reshape(1, -1)
        scores = (p - y).abs().amax(dim=1, keepdim=True)
        return mean, torch.maximum(spread, scores)

    def _extra_arrays(self):
        d = super()._extra_arrays()
        d['anchors_Y'] = None if self._anchors_Y is None \
            else self._anchors_Y.cpu().numpy()
        return d

    def _load_extra_arrays(self, arrays):
        super()._load_extra_arrays(arrays)
        self.anchors_Y = arrays.get('anchors_Y')
