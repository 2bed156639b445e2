"""Δ-UQ (anchoring).

Counterpart of ``nnueehcs_tpu/models/delta_uq.py``. The network's first
Linear takes ``2 * num_inputs`` features: an anchored input is
``concat([anchor, x - anchor])`` (on the channel axis for NCHW images,
whose first Conv2d takes ``2 * C`` channels). A UE pass evaluates the
network anchored at each of the first ``num_anchors`` stored anchors and
reports the mean and the unbiased std (``estimator='std'``) or variance
(``'var'``) over them.

Training (reference ``nnueehcs/models.py:306-311``): the forward takes the
doubled stochastic-centering batch, ``[[a1, x - a1]; [a2, x - a2]]`` with
``a1``, ``a2`` two independent permutations of the batch itself, against
the targets ``[y; y]``. The anchors are the first ``num_anchors`` training
inputs, captured during epoch 0 by the hook of :meth:`get_callbacks` and
installed before the first validation, which scores the anchored mean over
at most ``val_num_anchors`` of them (a batched pass: one anchored
evaluation of all its rows).

On the card the pass is the fused kernel
(:func:`~nnueehcs_tpu_torch.ops.fused_anchored.fused_anchored_stats`)
whenever the TPU kernel would take the network and at least two anchors are
used; on the CPU the same call runs its plain version. Otherwise (a CNN
among them) the anchored passes run through the modules in anchor groups
that keep at most :meth:`DeltaUQMLP._rows_budget` anchored rows in
flight, combined with Chan's parallel-variance update. The JAX package
makes its kernel opt-in; here it is the path. A model without anchors
raises: the JAX package's anchor-less fallback draws from ``jax.random``,
which the port cannot reproduce.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.fused_anchored import fused_anchored_stats, prepare_fused_anchored
from ..training.hooks import DeltaUQGetAnchorsHook
from .base import WrappedModelBase


def anchored_input(x, anchor):
    """``concat([anchor, x - anchor])`` on the feature axis (the channel
    axis for NCHW batches)."""
    dim = -3 if x.dim() >= 4 else -1
    return torch.cat([anchor, x - anchor], dim=dim)


class DeltaUQMLP(WrappedModelBase):
    uq_method = 'delta_uq'

    #: anchors used for validation losses during training (None: all)
    DEFAULT_VAL_NUM_ANCHORS = None
    #: most anchored rows in flight on the module path
    anchor_rows_budget = 1 << 20
    #: floor of the ``anchored_batch_size``-derived budget
    MIN_ROWS_BUDGET = 1 << 16

    def __init__(self, net, estimator: str = 'std', num_anchors: int = 5,
                 anchored_batch_size=None, val_num_anchors='default',
                 **kwargs):
        super().__init__(net, **kwargs)
        if estimator not in ('std', 'var'):
            raise ValueError(f'Unknown estimator {estimator!r}')
        self.estimator = estimator
        self.num_anchors = num_anchors
        self.val_num_anchors = self.DEFAULT_VAL_NUM_ANCHORS \
            if val_num_anchors == 'default' else val_num_anchors
        self.batch_size = sys.maxsize if anchored_batch_size is None \
            else anchored_batch_size
        self._anchors = None

    def _as_buffer(self, value):
        if value is None:
            return None
        return torch.tensor(np.asarray(value), dtype=torch.float32,
                            device=self.device)

    @property
    def anchors(self):
        return self._anchors

    @anchors.setter
    def anchors(self, value):
        self._anchors = self._as_buffer(value)

    def to(self, device):
        super().to(device)
        if self._anchors is not None:
            self._anchors = self._anchors.to(self.device)
        return self

    def get_callbacks(self):
        return [DeltaUQGetAnchorsHook()]

    # ------------------------------------------------------------- training
    def train_output(self, x, generator, perm, rows=None):
        """The doubled batch through the network in its current mode:
        ``(2B, out)`` for ``[[x[perm[0]], x - x[perm[0]]]; [x[perm[1]],
        x - x[perm[1]]]]``. ``perm`` is one step's ``(2, B)`` of
        :func:`~nnueehcs_tpu_torch.ops.fused_train.anchor_permutations`
        (the trainer's draws); ``generator`` feeds the Dropout layers.
        ``rows = (lo, hi)`` keeps rows ``lo .. hi - 1`` of each half (a
        rank's share of a batch split over ranks; the anchors still come
        from the whole batch)."""
        lo, hi = (0, x.shape[0]) if rows is None else rows
        xs = x[lo:hi]
        doubled = torch.cat([anchored_input(xs, x[perm[0][lo:hi]]),
                             anchored_input(xs, x[perm[1][lo:hi]])], dim=0)
        return self.net(doubled, generator)

    def train_targets(self, y):
        return torch.cat([y, y], dim=0)

    def training_loss(self, batch, generator, perm, rows=None):
        x, y = batch
        if rows is not None:
            y = y[rows[0]:rows[1]]
        return self.loss(self.train_output(x, generator, perm, rows),
                         self.train_targets(y))

    def _val_anchors(self) -> int:
        return self.num_anchors if self.val_num_anchors is None \
            else min(self.num_anchors, self.val_num_anchors)

    def validation_output(self, x, row0: int = 0, seeds=None,
                          rows_per_seed: int = 1):
        """The anchored mean over the first ``min(num_anchors,
        val_num_anchors)`` anchors (all of them when ``val_num_anchors``
        is None); the UE path always takes ``num_anchors``."""
        return self._anchored_stats(x, self._require_anchors(),
                                    self._val_anchors())[0]

    def validation_rows(self, x) -> int:
        """The model call's chunk on the kernel's path; on the module path
        also at most the rows budget, so one anchor's rows stay within
        it."""
        limit = super().validation_rows(x)
        if self._takes_kernel(x, self._require_anchors(),
                              self._val_anchors()):
            return limit
        return min(limit, self._rows_budget(x))

    # ----------------------------------------------------------------- eval
    def _rows_budget(self, x=None):
        """Most anchored rows in flight: ``anchored_batch_size`` anchors'
        worth of rows, floored at ``MIN_ROWS_BUDGET`` and capped at
        ``anchor_rows_budget``, as in the JAX package. Those are rows of at
        most ``ROW_ELEMENTS`` activations; an image batch ``x`` (NCHW)
        takes fewer rows, as many as hold the same activations at the
        network's widest layer (:meth:`row_elements` of an anchored
        row)."""
        if self.batch_size == sys.maxsize:
            rows = self.anchor_rows_budget
        else:
            rows = min(self.anchor_rows_budget,
                       max(self.num_anchors * self.batch_size,
                           self.MIN_ROWS_BUDGET))
        if x is not None and x.dim() > 2:
            rows = max(1, rows * self.ROW_ELEMENTS
                       // max(self.row_elements(x), self.ROW_ELEMENTS))
        return rows

    def _row_sample(self, x):
        return anchored_input(x[:1], x[:1])

    def anchored_weights(self):
        """The folded, split weights for the current parameters (None when
        the kernel does not take the network), rebuilt when they change."""
        return self._folded_weights(prepare_fused_anchored)

    def _require_anchors(self):
        if self._anchors is None:
            raise ValueError(
                f'{type(self).__name__} has no anchors: set model.anchors '
                '(the training inputs captured at epoch 0) before evaluating')
        return self._anchors

    def anchored_stats_modules(self, x, anchors, n_anchors):
        """Mean and spread over the anchored passes of the first
        ``n_anchors`` anchors, through the network's modules in groups of
        anchors, combined with Chan's update."""
        a_all = anchors[:n_anchors]
        k, rows = a_all.shape[0], x.shape[0]
        g = max(1, min(k, self._rows_budget(x) // max(rows, 1)))
        n, mean, m2 = 0, None, None
        for start in range(0, k, g):
            a = a_all[start:start + g]
            inp = anchored_input(
                x.unsqueeze(0).expand(a.shape[0], *x.shape),
                a.unsqueeze(1).expand((-1, rows) + a.shape[1:]))
            p = self.net(inp.reshape((-1,) + inp.shape[2:])).reshape(
                a.shape[0], rows, -1)
            cg = p.shape[0]
            mean_g = p.mean(0)
            m2_g = torch.square(p - mean_g).sum(0)
            if mean is None:
                n, mean, m2 = cg, mean_g, m2_g
            else:
                delta = mean_g - mean
                n_new = n + cg
                mean = mean + delta * (cg / n_new)
                m2 = m2 + m2_g + torch.square(delta) * (n * cg / n_new)
                n = n_new
        var = m2 / (n - 1)      # one anchor: 0/0, NaN as in the JAX package
        return mean, var if self.estimator == 'var' else torch.sqrt(var)

    def _takes_kernel(self, x, anchors, n_anchors) -> bool:
        """Whether an anchored pass over ``x`` and the first ``n_anchors``
        of ``anchors`` runs the fused kernel."""
        return self.anchored_weights() is not None and x.dim() == 2 \
            and min(n_anchors, anchors.shape[0]) >= 2

    def _anchored_stats(self, x, anchors, n_anchors):
        if self._takes_kernel(x, anchors, n_anchors):
            aw = self.anchored_weights()
            mean, std = fused_anchored_stats(aw, x, anchors, n_anchors)
            return mean, std * std if self.estimator == 'var' else std
        return self.anchored_stats_modules(x, anchors, n_anchors)

    def eval_output(self, x, return_ue: bool = False):
        mean, spread = self._anchored_stats(x, self._require_anchors(),
                                            self.num_anchors)
        return (mean, spread) if return_ue else mean

    def config_dict(self):
        d = super().config_dict()
        d['estimator'] = self.estimator
        d['num_anchors'] = self.num_anchors
        d['val_num_anchors'] = self.val_num_anchors
        d['anchored_batch_size'] = None if self.batch_size == sys.maxsize \
            else self.batch_size
        return d

    def _extra_arrays(self):
        return {'anchors': None if self._anchors is None
                else self._anchors.cpu().numpy()}

    def _load_extra_arrays(self, arrays):
        self.anchors = arrays.get('anchors')
