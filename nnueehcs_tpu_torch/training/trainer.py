"""The training loop.

Counterpart of ``nnueehcs_tpu/training/trainer.py`` (the reference's
Lightning ``Trainer``, reference ``nnueehcs/training.py:13-37``), with the
same explicit behaviours:

- clip by global norm (``gradient_clip_val``), Adam (0.9, 0.999, 1e-8) with
  bias correction, decayed weights (``weight_decay``) and ``p - lr * u``,
  the learning rate a runtime scalar that ``ReduceLROnPlateau`` on
  ``val_loss`` (torch defaults) scales;
- ``limit_train_batches``, ``limit_val_batches``, ``overfit_batches``,
  ``log_every_n_steps`` and ``max_epochs`` with Lightning semantics, and
  ``metrics.csv`` rows in the Lightning layout;
- hooks (``EarlyStopping``, ``ModelSavingCallback``, the KDE fit hooks) at
  the same points of the loop.

An epoch runs one of two ways, by the JAX package's dispatch rules. Where
the network fits the training kernel's plan, the trainer's precision is
None, ``'32-true'`` or ``'bf16-mixed'`` and no hook needs the epoch's
batches, the whole epoch is one call of
:func:`~nnueehcs_tpu_torch.ops.fused_train.fused_epoch` (the CUDA kernel on
the card; its bf16 form under ``'bf16-mixed'``) on flat fp32 buffers that
persist across epochs. Otherwise (the epoch 0 of KDE, kNN-KDE, Δ-UQ and
PAGER, whose hooks read its batches, a tail batch, a network the plan
rejects, ``fused_epochs: False``, a trainer precision of ``'bf16'``,
``'bf16-true'`` or ``'32'``) it runs step by step: torch autograd on the
model's ``training_loss`` through its modules, in the model's compute
dtype, and the optimizer above, written out. The two hand over to each
other with the Adam step count carried across. Validation goes through the
model's evaluation path. A trainer precision is recorded in the model's
``train_config`` and set on it; a model already in bf16 under a trainer
precision of None trains the kernel in fp32 and its per-step and
validation passes in bf16, as in JAX. Δ-UQ and PAGER train on the doubled
stochastic-centering batch (kernel epochs at batch ``2 * batch_size``).

Differences from the JAX trainer, by design: the shuffle draws from a
``torch.Generator``, not ``jax.random.permutation``, and so do the
Δ-UQ/PAGER anchor permutations (:meth:`Trainer.anchor_permutations`, one
stream for both paths) and the per-step path's dropout masks (the kernel's
are the JAX kernel's hash); ``whole_fit`` is read but every epoch runs on
its own; and training runs on one device (``mesh`` and ``devices`` raise
``NotImplementedError``).
"""
from __future__ import annotations

import math
import time
from typing import List, Optional

import numpy as np
import torch

from ..convert import load_pytrees, tensor_trees
from ..models.base import resolve_device
from ..ops import fused_train as ft
from .callbacks import EarlyStopping
from .data import DataLoader
from .hooks import TrainerHook
from .loggers import CSVLogger

_SINGLE_NET = ('MCDropoutModel', 'DeltaUQMLP', 'PAGERMLP', 'MLPModel',
               'KDEMLPModel', 'KNNKDEMLPModel', 'MVEMLPModel')
_ANCHORED = ('DeltaUQMLP', 'PAGERMLP')
# trainer precisions under which an epoch may run the training kernel
_KERNEL_PRECISIONS = (None, '32-true', 'bf16-mixed')


def _inst_init_if_not_none(inst, attr, val, default):
    setattr(inst, attr, val if val is not None else default)


class PlateauScheduler:
    """torch.optim.lr_scheduler.ReduceLROnPlateau('min') defaults."""

    def __init__(self, factor=0.1, patience=10, threshold=1e-4,
                 cooldown=0, min_scale=0.0):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.cooldown = cooldown
        self.min_scale = min_scale
        self.best = math.inf
        self.num_bad = 0
        self.cooldown_counter = 0
        self.scale = 1.0

    def step(self, metric: float):
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.cooldown_counter = self.cooldown
                self.num_bad = 0
        return self.scale


def _resolve_limit(limit, total: int) -> int:
    if limit is None:
        return total
    if isinstance(limit, float):
        return max(1, int(total * limit)) if limit < 1.0 else total
    return min(int(limit), total)


class Adam:
    """Clip by global norm, then Adam with bias correction, then decayed
    weights, then ``p - lr * u``: the JAX trainer's optax chain
    (``clip_by_global_norm``, ``scale_by_adam``, ``add_decayed_weights``)
    written out in its order of operations. ``count`` is the step count."""

    def __init__(self, params, clip=None, weight_decay=0.0, b1=0.9, b2=0.999,
                 eps=1e-8):
        self.params = list(params)
        self.clip = float(clip) if clip else None
        self.weight_decay = float(weight_decay or 0.0)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def moments(self, which: str) -> dict:
        """Parameter -> its first (``'mu'``) or second (``'nu'``) moment."""
        return dict(zip(self.params, getattr(self, which)))

    @torch.no_grad()
    def step(self, grads, lr):
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        if self.clip is not None:
            gn = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            grads = [torch.where(gn < self.clip, g, (g / gn) * self.clip)
                     for g in grads]
        self.count += 1
        dev = self.params[0].device
        t = torch.tensor(float(self.count), dtype=torch.float32, device=dev)
        c1 = 1 - torch.tensor(self.b1, dtype=torch.float32, device=dev) ** t
        c2 = 1 - torch.tensor(self.b2, dtype=torch.float32, device=dev) ** t
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.copy_(p - lr * u)


class Trainer:
    def __init__(self, name, trainer_config, logger=None, callbacks=None,
                 version=None, log_dir='logs', device='cuda'):
        self.name = name
        self.trainer_config = dict(trainer_config)
        cfg = self.trainer_config
        for key in ('mesh', 'devices'):
            if cfg.get(key):
                raise NotImplementedError(
                    f'trainer_config[{key!r}]: training on more than one '
                    'device is not ported; the port trains on one device')
        self.device = resolve_device(device)
        _inst_init_if_not_none(self, 'callbacks', callbacks,
                               [EarlyStopping(monitor='val_loss')])
        _inst_init_if_not_none(self, 'logger', logger,
                               CSVLogger(log_dir, name=name, version=version))
        self.logger.log_hyperparams(self.trainer_config)

        self.max_epochs = cfg.get('max_epochs', 1000)
        self.limit_train_batches = cfg.get('limit_train_batches', None)
        self.limit_val_batches = cfg.get('limit_val_batches', None)
        self.log_every_n_steps = cfg.get('log_every_n_steps', 50)
        self.gradient_clip_val = cfg.get('gradient_clip_val', None)
        self.overfit_batches = cfg.get('overfit_batches', 0)
        self.precision = cfg.get('precision', None)
        self.seed = cfg.get('seed', 42)

        self.should_stop = False
        self.current_epoch = 0
        self.global_step = 0
        self.callback_metrics = {}

    # ------------------------------------------------------------- accessors
    def get_logger(self):
        return self.logger

    def get_callbacks(self):
        return self.callbacks

    @classmethod
    def get_default_logdir(cls, dir, name, version):
        return CSVLogger(dir, name=name, version=version).log_dir

    # ------------------------------------------------------------ seeds
    def _epoch_seed(self, epoch: int) -> int:
        """Per-epoch seed of the kernel's dropout hash (the JAX trainer's;
        the kernel's per-step stride must stay different from 7919)."""
        return (self.seed * 1000003 + epoch * 7919) & 0x7fffffff

    def anchor_permutations(self, epoch: int, first_step: int, steps: int,
                            batch: int) -> torch.Tensor:
        """``(steps, 2, batch)``: the permutations that anchor the
        Δ-UQ/PAGER batches of steps ``first_step ..`` of ``epoch``, on the
        kernel path and the per-step path alike, drawn in order from the
        trainer's anchor stream (a ``torch.Generator`` seeded with
        ``seed + 2``). The JAX trainer draws them with
        ``jax.random.permutation`` from keys folded in by epoch and step; a
        caller may replace this method to feed those."""
        return ft.anchor_permutations(self._anchor_gen, steps, batch)

    def _val_seed(self, epoch: int, batch: int) -> int:
        """Sampling seed of validation batch ``batch`` at ``epoch`` (MC
        dropout's validation mean)."""
        return (self.seed * 1000003 + epoch * 100003 + batch) & 0x7fffffff

    def _log_epoch(self, losses_np, epoch):
        """Per-step train-loss rows (Lightning layout) and step accounting."""
        for b in range(losses_np.shape[0]):
            step = self.global_step + b
            if (step + 1) % self.log_every_n_steps == 0:
                self.logger.log_metrics(
                    {'train_loss': float(losses_np[b]), 'epoch': epoch},
                    step=step)
        self.global_step += int(losses_np.shape[0])
        if losses_np.shape[0]:
            self.callback_metrics['train_loss'] = float(losses_np[-1])

    def _weighted_val(self, model, x_val, y_val, val_bs, nb_val, epoch):
        """Size-weighted mean validation loss over the first ``nb_val``
        batches, through the model's evaluation path."""
        model.net.eval()
        losses, weights = [], []
        n_val = x_val.shape[0]
        for b in range(nb_val):
            lo = b * val_bs
            hi = min(lo + val_bs, n_val)
            if lo >= hi:
                break
            losses.append(model.validation_loss(
                (x_val[lo:hi], y_val[lo:hi]), seed=self._val_seed(epoch, b)))
            weights.append(hi - lo)
        losses = torch.stack(losses).cpu().numpy()
        return float(np.average(losses.astype(np.float64), weights=weights))

    def validate(self, model, dataloaders) -> float:
        """A standalone validation pass: the sample-weighted mean
        validation loss over the loader (no training, no hooks)."""
        dl = dataloaders
        model.to(self.device)
        x = torch.as_tensor(np.asarray(dl.inputs), dtype=torch.float32,
                            device=self.device)
        y = torch.as_tensor(np.asarray(dl.outputs), dtype=torch.float32,
                            device=self.device)
        bs = dl.batch_size
        return self._weighted_val(model, x, y, bs, -(-x.shape[0] // bs), 0)

    # ------------------------------------------------------------------ fit
    def fit(self, model, train_dataloaders, val_dataloaders=None):
        # epochs that ran through the training kernel (observable)
        self.fused_epochs_used = 0
        return self._fit(model, train_dataloaders, val_dataloaders)

    def _fit(self, model, train_dl: DataLoader, val_dl: Optional[DataLoader]):
        kind = type(model).__name__
        anchored = kind in _ANCHORED
        if val_dl is None:
            val_dl = train_dl
        device = self.device
        model.to(device)
        if self.precision is not None:
            # recorded on the model, so the bundle restores it
            model.train_config['precision'] = self.precision
            model.set_precision(self.precision)

        def as_dev(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                   device=device)

        x_train, y_train = as_dev(train_dl.inputs), as_dev(train_dl.outputs)
        bs = train_dl.batch_size
        n = x_train.shape[0]

        # ----- batching plan (Lightning semantics)
        overfit = self.overfit_batches
        if overfit:
            nb_train = int(overfit) if overfit >= 1 else \
                max(1, int((n // bs) * overfit))
            shuffle = False
            val_bs = bs
            nb_val = nb_train
            val_lim = min(nb_train * bs, n)
            x_val, y_val = x_train[:val_lim], y_train[:val_lim]
        else:
            nb_full = n // bs if train_dl.drop_last else -(-n // bs)
            nb_train = max(_resolve_limit(self.limit_train_batches, nb_full), 1)
            shuffle = train_dl.shuffle
            val_bs = val_dl.batch_size
            n_val_avail = len(val_dl.inputs)
            nb_val = max(_resolve_limit(self.limit_val_batches,
                                        -(-n_val_avail // val_bs)), 1)
            # only the rows the first nb_val batches read go to the device
            val_lim = min(nb_val * val_bs, n_val_avail)
            x_val = as_dev(val_dl.inputs[:val_lim])
            y_val = as_dev(val_dl.outputs[:val_lim])

        # ----- optimizer
        weight_decay = float(model.train_config.get('weight_decay', 0) or 0)
        base_lr = float(model.train_config['learning_rate'])
        params = list(model.net.parameters())
        opt = Adam(params, clip=self.gradient_clip_val,
                   weight_decay=weight_decay)

        # ----- the training kernel's plan (the JAX trainer's dispatch rules)
        fused_cfg = self.trainer_config.get('fused_epochs', True)
        fused_plan = None
        single_net = kind in _SINGLE_NET
        if fused_cfg and (device.type == 'cuda' or fused_cfg == 'force') \
                and self.precision in _KERNEL_PRECISIONS \
                and (single_net or kind == 'EnsembleModel'):
            fused_plan = ft.plan_fused_train(
                model.net, 1 if single_net else model.num_models,
                2 * bs if anchored else bs,
                loss='gaussian_nll' if kind == 'MVEMLPModel'
                else model.train_config.get('loss', 'l1_loss'),
                per_member=not single_net and model.train_config.get(
                    'ensemble_loss', 'joint_mean') == 'per_member',
                clip=self.gradient_clip_val, weight_decay=weight_decay,
                bf16=self.precision == 'bf16-mixed',
                member_stacked=not single_net)
        fused_buffers = None
        fused_step0 = 0
        drops = ft.drop_rates(model.net).to(device)
        num_layers = len(model.net.layers)

        def pack_fused():
            p_tree, s_tree = tensor_trees(model.net)
            mu_tree, _ = tensor_trees(model.net, opt.moments('mu'))
            nu_tree, _ = tensor_trees(model.net, opt.moments('nu'))
            return [ft.pack_tree(fused_plan, p_tree, device),
                    ft.pack_tree(fused_plan, mu_tree, device),
                    ft.pack_tree(fused_plan, nu_tree, device),
                    ft.pack_state(fused_plan, s_tree, device)], opt.count

        def unpack_fused(bufs):
            """Parameters and BatchNorm state back into the network."""
            load_pytrees(model.net,
                         ft.unpack_tree(fused_plan, bufs[0], num_layers),
                         ft.unpack_state(fused_plan, bufs[3], num_layers))

        # ----- hooks
        hooks: List[TrainerHook] = list(self.callbacks)
        for h in hooks:
            h.on_fit_start(self, model)
        self.logger.log_hyperparams({
            'train_config': model.train_config,
            'validation_config': model.validation_config})
        plateau = PlateauScheduler()
        lr_scale = 1.0

        def val_fusion_ok(epoch):
            return all(h.fusion_quiescent(epoch) for h in hooks)

        nb_val_full = min(nb_val, x_val.shape[0] // val_bs)

        # ----- batching geometry, constant across epochs
        full_batches = min(nb_train, n // bs)
        tail_len = n % bs
        has_tail = (not train_dl.drop_last) and tail_len > 0 \
            and nb_train > full_batches
        sample_n = full_batches * bs
        # with limit_train_batches sampling a slice of the data, one
        # permutation serves `windows` epochs as disjoint windows
        windows = max(1, n // sample_n) \
            if (shuffle and not has_tail and sample_n > 0) else 1
        perm = None if shuffle else torch.arange(n, device=device)
        shuffle_gen = torch.Generator(device=device).manual_seed(self.seed)
        dropout_gen = torch.Generator(device=device).manual_seed(self.seed + 1)
        self._anchor_gen = torch.Generator(device=device).manual_seed(
            self.seed + 2)

        def train_step(idx, lr, anchor_perm=None):
            model.net.train()
            batch = (x_train[idx], y_train[idx])
            loss = model.training_loss(batch, dropout_gen, anchor_perm) \
                if anchored else model.training_loss(batch, dropout_gen)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            opt.step(grads, lr)
            return loss.detach()

        fit_start = time.time()
        for epoch in range(self.max_epochs):
            self.current_epoch = epoch
            if shuffle and epoch % windows == 0:
                perm = torch.randperm(n, generator=shuffle_gen, device=device)
            offset = (epoch % windows) * sample_n
            lr = base_lr * lr_scale
            batch_hooks = [h for h in hooks if _wants_batches(h, epoch)]

            kernel_ok = (fused_plan is not None and nb_val_full > 0
                         and val_fusion_ok(epoch) and not batch_hooks
                         and not has_tail and full_batches > 0)
            if kernel_ok:
                # ---- the whole epoch in one call of the training kernel
                self.fused_epochs_used += 1
                if fused_buffers is None:
                    fused_buffers, fused_step0 = pack_fused()
                idx = perm[offset:offset + sample_n]
                if anchored:
                    xs, ys = ft.gather_anchored_epoch_batches(
                        fused_plan, x_train, y_train, idx,
                        self.anchor_permutations(epoch, 0, full_batches, bs))
                else:
                    xs, ys = ft.gather_epoch_batches(fused_plan, x_train,
                                                     y_train, idx)
                *_, losses = ft.fused_epoch(
                    fused_plan, *fused_buffers, xs, ys, lr, fused_step0,
                    seed=self._epoch_seed(epoch), drops=drops)
                fused_step0 += full_batches
                unpack_fused(fused_buffers)
                losses_np = losses.cpu().numpy()
            else:
                if fused_buffers is not None:
                    # a per-step epoch follows kernel epochs: hand the
                    # parameters and the Adam state back (for good, as the
                    # JAX trainer does)
                    unpack_fused(fused_buffers)
                    for buf, which in ((1, 'mu'), (2, 'nu')):
                        load_pytrees(model.net, ft.unpack_tree(
                            fused_plan, fused_buffers[buf], num_layers),
                            None, values=opt.moments(which))
                    opt.count = fused_step0
                    fused_buffers = None
                    fused_plan = None
                idx_mat = perm[offset:offset + sample_n].reshape(
                    full_batches, bs)
                # hooks that only read batch data get the batches after
                # the steps, from the host arrays
                data_only = all(getattr(h, 'batch_data_only', False)
                                for h in batch_hooks)
                anchor_perms = self.anchor_permutations(
                    epoch, 0, full_batches, bs) if anchored else None
                losses = []
                for b in range(full_batches):
                    losses.append(train_step(
                        idx_mat[b], lr,
                        None if anchor_perms is None else anchor_perms[b]))
                    if batch_hooks and not data_only:
                        batch = (x_train[idx_mat[b]], y_train[idx_mat[b]])
                        for h in batch_hooks:
                            h.on_train_batch_end(self, model, batch, b)
                if batch_hooks and data_only:
                    idx_np = idx_mat.cpu().numpy()
                    xs_np = np.asarray(train_dl.inputs)
                    ys_np = np.asarray(train_dl.outputs)
                    for b in range(full_batches):
                        batch = (xs_np[idx_np[b]].astype(np.float32, copy=False),
                                 ys_np[idx_np[b]].astype(np.float32, copy=False))
                        for h in batch_hooks:
                            h.on_train_batch_end(self, model, batch, b)
                if has_tail:
                    tail_idx = perm[sample_n:sample_n + tail_len]
                    losses.append(train_step(
                        tail_idx, lr, self.anchor_permutations(
                            epoch, full_batches, 1, tail_len)[0]
                        if anchored else None))
                    if batch_hooks:
                        batch = (x_train[tail_idx], y_train[tail_idx])
                        for h in batch_hooks:
                            h.on_train_batch_end(self, model, batch,
                                                 full_batches)
                model.net.eval()
                losses_np = torch.stack(losses).cpu().numpy() if losses \
                    else np.zeros(0, np.float32)

            self._log_epoch(losses_np, epoch)
            for h in hooks:
                h.on_train_epoch_end(self, model)
            for h in hooks:
                h.on_validation_epoch_start(self, model)
            vl = self._weighted_val(model, x_val, y_val, val_bs, nb_val, epoch)
            self.callback_metrics['val_loss'] = vl
            self.logger.log_metrics({'val_loss': vl, 'epoch': epoch},
                                    step=self.global_step - 1)
            for h in hooks:
                h.on_validation_end(self, model, self.callback_metrics)
            lr_scale = plateau.step(vl)
            self.logger.save()
            if self.should_stop:
                break

        model.net.eval()
        for h in hooks:
            h.on_fit_end(self, model)
        self.fit_time = time.time() - fit_start
        self.logger.finalize()
        return model


def _wants_batches(hook: TrainerHook, epoch: int) -> bool:
    custom = type(hook).on_train_batch_end is not TrainerHook.on_train_batch_end
    if not custom:
        return False
    wants = getattr(hook, 'wants_train_batches', None)
    if wants is not None:
        return wants(epoch)
    # the built-in fit hooks only observe epoch 0
    return epoch == 0 or not hasattr(hook, '_epochs')
