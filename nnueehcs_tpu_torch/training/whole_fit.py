"""Whole-fit dispatch: the trainer's decisions between kernel epochs, kept
on the card.

Counterpart of the state that ``nnueehcs_tpu/training/trainer.py``'s
``whole_fit_kernel`` carries through its ``lax.while_loop``: the plateau
schedule, early stopping, the best-parameter pin and the per-epoch loss
buffers. The port keeps the JAX package's loop on the host and enqueues
each epoch's work without waiting for the card: every value a decision
reads is a tensor on the buffers' device, updated by stream-ordered tensor
operations after the epoch's validation, and the kernel reads the learning
rate and the stop flag from device memory (``fused_epoch(lr=..., stop=...)``).

Decisions are taken in float64, as the port's host code takes them
(:class:`~nnueehcs_tpu_torch.training.trainer.PlateauScheduler`,
:class:`~nnueehcs_tpu_torch.training.callbacks.EarlyStopping`), on the
validation loss of :func:`weighted_mean`, which the per-epoch path reads
back; the JAX package compares in float32. Every update is masked by the
flag the epoch started with, so an epoch enqueued after the card stopped
changes nothing.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.fused_ensemble import device_values


def weighted_mean(losses: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """The ``weights``-weighted mean of the 1-D ``losses`` in float64, as
    a 0-d tensor on their device: the one reduction of both the per-epoch
    path (which reads it back) and the whole fit (which keeps it on the
    card), so the two agree bit for bit. ``weights``: float64 on the
    losses' device."""
    return (losses.to(torch.float64) * weights).sum() / weights.sum()


class DeviceDecisions:
    """The plateau schedule, early stopping and the best pin of one
    whole-fit dispatch from epoch ``e0``, as tensors on ``device``.

    ``plateau`` and ``early_stopping`` (or None) seed the state with the
    host objects' values at the dispatch; the host objects replay the same
    decisions afterwards from the loss buffers. The learning rate of an
    epoch is ``lr_table[reductions]``: the host builds the table as the
    host path forms its learning rate, ``float32(base_lr * scale)`` after
    each number of reductions, so the kernel reads the host path's value
    bit for bit. ``stop`` (one int32) is the flag the kernel reads."""

    def __init__(self, device, plateau, early_stopping, base_lr: float,
                 e0: int, max_epochs: int, steps: int, theta, sigma):
        def full(value, dtype):
            return torch.full((), value, dtype=dtype, device=device)
        f64, i64 = torch.float64, torch.int64
        self.e0 = e0
        self.plateau = (plateau.factor, plateau.patience, plateau.threshold,
                        plateau.cooldown)
        self.p_best = full(plateau.best, f64)
        self.p_bad = full(plateau.num_bad, i64)
        self.p_cool = full(plateau.cooldown_counter, i64)
        self.reductions = full(0, i64)
        scales = [plateau.scale]
        for _ in range(max_epochs - e0):
            scales.append(max(scales[-1] * plateau.factor, plateau.min_scale))
        self.lr_table = device_values(
            [float(np.float32(base_lr * s)) for s in scales], torch.float32,
            device)
        self.lr = torch.empty(1, dtype=torch.float32, device=device)
        self.early = early_stopping is not None
        if self.early:
            self.es_min_delta = early_stopping.min_delta
            self.es_patience = early_stopping.patience
            self.es_best = full(early_stopping.best_score, f64)
            self.es_wait = full(early_stopping.wait_count, i64)
        self.stop = torch.zeros(1, dtype=torch.int32, device=device)
        self.best_vl = full(math.inf, f64)
        self.best_theta = theta.clone()
        self.best_sigma = sigma.clone()
        self.losses = torch.zeros((max_epochs, steps), dtype=torch.float32,
                                  device=device)
        self.val_losses = torch.full((max_epochs,), math.nan, dtype=f64,
                                     device=device)
        self.done = full(e0, i64)
        self._nan = full(math.nan, f64)

    def begin_epoch(self) -> torch.Tensor:
        """The flag the epoch starts with (True: it trains) and its
        learning rate in ``self.lr``."""
        torch.index_select(self.lr_table, 0, self.reductions.reshape(1),
                           out=self.lr)
        return (self.stop == 0).reshape(())

    def end_epoch(self, epoch: int, run, losses, vl, theta, sigma):
        """Record epoch ``epoch``'s step losses and validation loss ``vl``
        (float64, 0-d) and take its decisions, all masked by ``run``."""
        self.losses[epoch].copy_(torch.where(run, losses,
                                             self.losses[epoch]))
        self.val_losses[epoch].copy_(torch.where(run, vl, self._nan))

        # ReduceLROnPlateau('min'); the new scale applies from the next epoch
        factor, patience, threshold, cooldown = self.plateau
        imp = vl < self.p_best * (1 - threshold)
        in_cool = self.p_cool > 0
        bad = self.p_bad + 1
        trig = ~imp & ~in_cool & (bad > patience)
        self._set(self.p_best, run, torch.where(imp, vl, self.p_best))
        self._set(self.p_bad, run, torch.where(imp | in_cool | trig,
                                               torch.zeros_like(bad), bad))
        cool = torch.where(in_cool, self.p_cool - 1,
                           torch.where(trig, torch.full_like(bad, cooldown),
                                       self.p_cool))
        self._set(self.p_cool, run, torch.where(imp, self.p_cool, cool))
        self._set(self.reductions, run, self.reductions + trig.long())

        # EarlyStopping('val_loss', 'min'): stop before the next epoch
        stop_now = torch.zeros_like(run)
        if self.early:
            eimp = vl < self.es_best - self.es_min_delta
            wait = torch.where(eimp, torch.zeros_like(self.es_wait),
                               self.es_wait + 1)
            stop_now = ~eimp & (wait >= self.es_patience)
            self._set(self.es_best, run, torch.where(eimp, vl, self.es_best))
            self._set(self.es_wait, run, wait)

        # the best pin (ModelSavingCallback): the first epoch of the
        # dispatch unconditionally, then only finite improvements
        better = ~torch.isnan(vl) & ((vl < self.best_vl)
                                     | torch.isnan(self.best_vl))
        pin = run & better if epoch != self.e0 else run
        self.best_vl.copy_(torch.where(pin, vl, self.best_vl))
        self.best_theta.copy_(torch.where(pin, theta, self.best_theta))
        self.best_sigma.copy_(torch.where(pin, sigma, self.best_sigma))

        self.done.add_(run.long())
        self.stop.copy_((self.stop != 0) | (run & stop_now))

    @staticmethod
    def _set(state, run, new):
        state.copy_(torch.where(run, new, state))


class StopPoll:
    """Reads the card's stop flag without waiting: after an epoch's
    decisions, the flag is copied into one of ``slots`` pinned host words
    behind an event; :meth:`stopped` looks only at copies whose events have
    completed. When every slot is still in flight, that epoch's flag is
    not copied (a later one will be)."""

    def __init__(self, device, slots: int = 2):
        self.cuda = torch.device(device).type == 'cuda'
        self.free = [torch.zeros(1, dtype=torch.int32, pin_memory=self.cuda)
                     for _ in range(slots)]
        self.pending = []

    def record(self, stop):
        if not self.free:
            return
        host = self.free.pop()
        host.copy_(stop, non_blocking=True)
        event = None
        if self.cuda:
            event = torch.cuda.Event()
            event.record()
        self.pending.append((event, host))

    def stopped(self) -> bool:
        seen = False
        while self.pending and (self.pending[0][0] is None
                                or self.pending[0][0].query()):
            _, host = self.pending.pop(0)
            seen = seen or int(host[0]) != 0
            self.free.append(host)
        return seen
