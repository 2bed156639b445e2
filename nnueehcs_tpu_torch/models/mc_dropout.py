"""Monte-Carlo dropout.

Counterpart of ``nnueehcs_tpu/models/mc_dropout.py``. Training runs one
stochastic pass (the Dropout layers in training mode); validation scores
the MC mean drawn with the trainer's per-batch seed; a batched pass
draws every batch with its seed in one call (the kernels' seed table). A UE pass keeps
BatchNorm in eval mode, runs one dropout-free forward as the shift and
``num_samples`` forwards with dropout masks, and reports the mean and the
unbiased std over the samples. On the card the whole pass is the fused
kernel (:func:`~nnueehcs_tpu_torch.ops.fused_mc_dropout.fused_mc_forward`)
whenever the TPU kernel would take the network; otherwise, and on the CPU,
it runs the same function in plain tensor ops.

The masks come from a counter-based hash of (call seed, sample, Dropout
index, row, column), not from the JAX package's ``jax.random`` stream, so
the two packages agree statistically, not draw for draw, whatever
``prng_impl`` a bundle names. As in the JAX package, every call draws new
masks (a per-call counter feeds the seed) and ``reseed(s)`` repeats the
stream from its start. On a dp mesh every rank makes the same calls, so
their counters stay in step, and a rank hashes its rows by their index in
the whole bucket: the sharded answer is the unsharded one bit for bit.
"""
from __future__ import annotations

import torch

from ..nn.layers import Dropout
from ..ops.fused_mc_dropout import (fused_mc_forward, mc_call_seed,
                                    mc_forward_modules, prepare_mc_weights)
from .base import WrappedModelBase


class MCDropoutModel(WrappedModelBase):
    uq_method = 'mc_dropout'

    def __init__(self, net, num_samples: int = 100,
                 dropout_percent: float = 0.5, vectorize: bool = True,
                 prng_impl: str = None, **kwargs):
        # every Dropout takes the model's rate, as in the JAX package
        for layer in net.layers:
            if isinstance(layer, Dropout):
                layer.p = float(dropout_percent)
        super().__init__(net, **kwargs)
        self.num_samples = num_samples
        self.dropout_percent = dropout_percent
        self.vectorize = vectorize
        # kept for bundles only: the port's masks always come from the hash
        self.prng_impl = prng_impl or 'rbg'
        self.reseed(0)

    def reseed(self, seed: int):
        """Restart the sampling stream: the next call draws what the first
        call after any ``reseed(seed)`` draws."""
        self._base_seed = int(seed)
        self._eval_calls = 0
        return self

    def call_seed(self, index: int) -> int:
        """The mask seed of the ``index``-th call since the last reseed."""
        return mc_call_seed(self._base_seed, index)

    def mc_weights(self):
        """The folded, packed weights for the current parameters (None when
        the kernel does not take the network), rebuilt when they change."""
        return self._folded_weights(prepare_mc_weights)

    def mc_stats(self, x, seed: int, row0: int = 0, seeds=None,
                 rows_per_seed: int = 1):
        """Mean and std of ``num_samples`` masked passes drawn with
        ``seed`` (or the seed table ``seeds``, one seed for each
        ``rows_per_seed`` rows), ``x``'s first row row ``row0`` of the
        masks."""
        mw = self.mc_weights()
        if mw is not None:
            return fused_mc_forward(mw, x, self.num_samples, seed, row0,
                                    seeds, rows_per_seed)
        return mc_forward_modules(self.net, x, self.num_samples, seed, row0,
                                  seeds, rows_per_seed)

    def eval_rows(self, x, lo: int, hi: int, return_ue: bool = False):
        return self.eval_output(x[lo:hi], return_ue=return_ue, row0=lo)

    def eval_output(self, x, return_ue: bool = False, row0: int = 0):
        """The next call's statistics of ``x``, its first row row ``row0``
        of the masks."""
        seed = self.call_seed(self._eval_calls)
        self._eval_calls += 1
        mean, std = self.mc_stats(x, seed, row0)
        return (mean, std) if return_ue else mean

    def validation_loss(self, batch, seed: int = 0):
        """The loss of the MC mean drawn with ``seed`` (the trainer's
        per-batch validation seed); the serving stream does not advance."""
        x, y = batch
        with torch.no_grad():
            return self.loss(self.mc_stats(x, seed)[0], y)

    def validation_output(self, x, row0: int = 0, seeds=None,
                          rows_per_seed: int = 1):
        """The MC mean of rows ``x`` of a batched validation pass, row
        ``row0`` on, each batch of ``rows_per_seed`` rows drawn with its
        seed in ``seeds``, as :meth:`validation_loss` draws that batch
        alone: one call with the seed table."""
        return self.mc_stats(x, 0, row0, seeds, rows_per_seed)[0]

    def config_dict(self):
        d = super().config_dict()
        d['num_samples'] = self.num_samples
        d['dropout_percent'] = self.dropout_percent
        d['vectorize'] = self.vectorize
        d['prng_impl'] = self.prng_impl
        return d
