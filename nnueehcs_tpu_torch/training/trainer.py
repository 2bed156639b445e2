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
  the same points of the loop;
- the device from ``accelerator`` as the JAX trainer's ``_device`` reads
  it (``'cpu'`` the CPU, anything else the card; :func:`trainer_device`),
  unless the caller passes ``device``.

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
model's evaluation path, every full batch in one call
(``validation_losses``, the JAX trainer's ``get_val_scan``: one launch of
the model's kernel for the pass on the card) and a partial tail batch in
one more. A trainer precision is recorded in the model's
``train_config`` and set on it; a model already in bf16 under a trainer
precision of None trains the kernel in fp32 and its per-step and
validation passes in bf16, as in JAX. Δ-UQ and PAGER train on the doubled
stochastic-centering batch (kernel epochs at batch ``2 * batch_size``).

Whole fit (``whole_fit``: ``False``, ``True`` or ``'auto'``, the
default), the JAX trainer's one-program fit: once every remaining epoch
may run the kernel and every hook's validation behaviour can be replayed
(the JAX package's ``_whole_fit_ok`` rules: one EarlyStopping and any
ModelSavingCallback on ``val_loss``, no other ``on_validation_end``, no
batch hooks), the trainer enqueues every remaining epoch without waiting
for the card: the shuffle window, the (anchored) gather, the kernel, the
validation pass (every full batch in one evaluation, the JAX trainer's
scan) and its size-weighted mean in float64, then
ReduceLROnPlateau, EarlyStopping and the best-parameter pin as tensors on
the card (:mod:`~nnueehcs_tpu_torch.training.whole_fit`). The kernel
reads its learning rate and a stop flag from device memory; epochs the
host enqueued past the card's stop change nothing. The host looks at the
stop flag only through copies the card has finished (no wait), waits once
after the last epoch, then replays the logs and hooks from the per-epoch
loss buffers, ModelSavingCallback only at the best epoch, with the pinned
parameters in the modules. ``'auto'`` engages whenever the fit is
eligible.

Differences from the JAX trainer, by design: the shuffle draws from a
``torch.Generator``, not ``jax.random.permutation``, and so do the
Δ-UQ/PAGER anchor permutations (:meth:`Trainer.anchor_permutations`, one
stream for both paths) and the per-step path's dropout masks (the kernel's
are the JAX kernel's hash). In the whole fit: the card's decisions are
taken in float64 on the host path's validation loss (JAX compares in
float32); a failed dispatch raises, where JAX falls back to per-epoch
kernels (a CUDA error after a launch leaves the context unusable); the
``'auto'`` has no break-even or survival delay (JAX's 160 / 120 / 40
epochs pay for its compile; the port's dispatch costs a few milliseconds
of host set-up, under one epoch's saving, measured on the card,
``PERF.md``); there is no environment switch
(``NNUEEHCS_TPU_NO_WHOLE_FIT``), the config key is the only one.

Meshes: ``trainer_config['mesh']`` (an ``{axis: size}`` dict or
``'auto'``) makes a :class:`~nnueehcs_tpu_torch.parallel.Mesh` over the
ranks of the process group, rank ``r`` on ``devices[r]`` when
``trainer_config['devices']`` lists them (without a mesh, ``devices``
names the one device, its first). The rank trains on its mesh device;
a ``device`` (or an accelerator) that asks for another one raises
``ValueError``. Every rank builds the same trainer and
calls ``fit`` with the same model and loaders, as JAX's one controller
does once. A mesh of more than one rank trains step by step, as the JAX
trainer turns its kernel off under a mesh, through
:mod:`~nnueehcs_tpu_torch.training.sharded`, which keeps the unsharded
step's mathematics (global batch statistics, the loss's share, summed
gradients, the global clip norm, the same shuffle and dropout masks).
Validation losses are rank 0's on every rank, so every rank stops on the
same epoch; only rank 0 writes the logs and the bundle, whose weights are
gathered whole. A mesh of one rank (``{'dp': 1}``) is one device and may
run the training kernel and the whole fit, where the JAX trainer turns
the kernel off under any mesh.
"""
from __future__ import annotations

import math
import time
from typing import List, Optional

import numpy as np
import torch

from ..convert import load_pytrees, tensor_trees
from ..models.base import resolve_device
from ..ops.fused_ensemble import device_values
from ..ops import fused_train as ft
from ..parallel.mesh import make_mesh, placed
from .callbacks import EarlyStopping, ModelSavingCallback
from .data import DataLoader
from .hooks import TrainerHook
from .loggers import CSVLogger
from .sharded import ShardedTraining
from .whole_fit import DeviceDecisions, StopPoll, weighted_mean

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
                 eps=1e-8, sq_norm=None):
        self.params = list(params)
        # the gradients' global squared norm (a sharded fit's collectives)
        self.sq_norm = sq_norm
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
            gn = torch.sqrt(self.sq_norm(grads) if self.sq_norm is not None
                            else sum(torch.sum(g * g) for g in grads))
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


def trainer_device(accelerator='auto', device=None) -> torch.device:
    """The device a trainer runs on, from its config's ``accelerator`` as
    the JAX trainer's ``_device`` reads it and an explicit ``device``:
    ``'cpu'`` is the CPU; any other value (``'auto'``, ``'gpu'``,
    ``'cuda'``) is the card, which must exist (no fallback). An explicit
    ``device`` wins over those; ``'cpu'`` with a CUDA ``device`` is a
    conflict."""
    if device is None:
        return resolve_device('cpu' if accelerator == 'cpu' else 'cuda')
    dev = torch.device(device)
    if accelerator == 'cpu' and dev.type != 'cpu':
        raise ValueError(f"trainer_config accelerator 'cpu' conflicts with "
                         f'device {device!r}')
    return resolve_device(dev)


class _RankLogger(CSVLogger):
    """The logger of a rank other than 0: the same directory, no files."""

    def log_hyperparams(self, params: dict):
        self._hparams.update(params)

    def save(self):
        pass


class Trainer:
    def __init__(self, name, trainer_config, logger=None, callbacks=None,
                 version=None, log_dir='logs', device=None):
        self.name = name
        self.trainer_config = dict(trainer_config)
        cfg = self.trainer_config
        self.accelerator = cfg.get('accelerator', 'auto')
        # mesh: None (one device), 'auto' (every rank on dp) or an
        # {axis: size} dict; devices: each rank's device, in rank order
        self.mesh_config = cfg.get('mesh', None)
        self.devices = cfg.get('devices', None)
        self.mesh = make_mesh(self.mesh_config, self.devices) \
            if self.mesh_config else None
        if self.mesh is not None:
            # the mesh's device, which must be the one asked for
            device = placed(self.mesh, device if device is not None else
                            'cpu' if self.accelerator == 'cpu' else 'cuda')
        elif device is None and self.devices:
            device = self.devices[0]
            if isinstance(device, int):          # a card's index
                device = torch.device('cuda', device)
        self.device = trainer_device(self.accelerator, device)
        rank0 = self.mesh is None or self.mesh.rank == 0
        _inst_init_if_not_none(self, 'callbacks', callbacks,
                               [EarlyStopping(monitor='val_loss')])
        _inst_init_if_not_none(self, 'logger', logger,
                               (CSVLogger if rank0 else _RankLogger)(
                                   log_dir, name=name, version=version))
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

    @staticmethod
    def _val_bounds(n_val, val_bs, nb_val):
        """The row ranges of the first ``nb_val`` validation batches."""
        return [(b * val_bs, min(b * val_bs + val_bs, n_val))
                for b in range(nb_val) if b * val_bs < n_val]

    def _val_weights(self, x_val, val_bs, nb_val) -> torch.Tensor:
        """The sizes of the first ``nb_val`` validation batches, the
        weights of their mean, as float64 on ``x_val``'s device."""
        return device_values([hi - lo for lo, hi in self._val_bounds(
            x_val.shape[0], val_bs, nb_val)], torch.float64, x_val.device)

    def _val_losses(self, model, x_val, y_val, val_bs, nb_val,
                    epoch) -> torch.Tensor:
        """The losses of the first ``nb_val`` validation batches, in batch
        order as one tensor on the device, through the model's evaluation
        path, as the JAX trainer scans them: every full batch from one
        ``validation_losses`` call (one evaluation of all their rows, each
        batch drawn with its seed), then a partial tail batch, if any, from
        one ``validation_loss`` call. A model without ``validation_losses``
        (one that keeps to the JAX package's ``validation_loss``) is scored
        a batch at a time."""
        model.net.eval()
        bounds = self._val_bounds(x_val.shape[0], val_bs, nb_val)
        nb_full = min(nb_val, x_val.shape[0] // val_bs)
        if not hasattr(model, 'validation_losses'):
            nb_full = 0
        parts = []
        if nb_full:
            rows = nb_full * val_bs
            parts.append(model.validation_losses(
                x_val[:rows].reshape((nb_full, val_bs) + x_val.shape[1:]),
                y_val[:rows].reshape((nb_full, val_bs) + y_val.shape[1:]),
                [self._val_seed(epoch, b) for b in range(nb_full)]))
        parts.extend(
            model.validation_loss((x_val[lo:hi], y_val[lo:hi]),
                                  seed=self._val_seed(epoch, b))[None]
            for b, (lo, hi) in enumerate(bounds[nb_full:], nb_full))
        return torch.cat(parts)

    def _weighted_val(self, model, x_val, y_val, val_bs, nb_val, epoch):
        """Size-weighted mean validation loss over the first ``nb_val``
        batches, through the model's evaluation path: the whole fit's
        :func:`~nnueehcs_tpu_torch.training.whole_fit.weighted_mean`, read
        back."""
        return float(weighted_mean(
            self._val_losses(model, x_val, y_val, val_bs, nb_val, epoch),
            self._val_weights(x_val, val_bs, nb_val)))

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

    def _enqueue_whole_fit(self, enqueue, poll, e0: int) -> int:
        """Enqueue epochs ``e0 ..`` of a whole-fit dispatch, ``enqueue(e)``
        each, without waiting for the card; before each epoch after the
        first, the host looks at the copies of the stop flag that the card
        has finished (``poll``) and ends the dispatch when one is set.
        Returns the number of epochs enqueued: those past the card's stop
        change nothing."""
        e = e0
        while e < self.max_epochs:
            if e > e0 and poll.stopped():
                break
            enqueue(e)
            e += 1
        return e - e0

    # ------------------------------------------------------------------ fit
    def fit(self, model, train_dataloaders, val_dataloaders=None):
        # epochs that ran through the training kernel, whole-fit dispatches
        # and the epochs a dispatch enqueued past the card's stop
        # (observable)
        self.fused_epochs_used = 0
        self.whole_fit_dispatches = 0
        self.whole_fit_epochs_lost = 0
        self.whole_fit_seconds = None
        # the plateau scale each epoch trained with, in epoch order
        self.lr_scales = []
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
        mesh = self.mesh
        sharded = mesh is not None and not mesh.is_trivial
        if mesh is not None:
            model.attach_mesh(mesh)

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
        shards = None
        if sharded:
            if bs < mesh.axis_size('dp'):
                raise ValueError(f'batch size {bs} is smaller than the mesh '
                                 f"axis 'dp' of size {mesh.axis_size('dp')}")
            shards = ShardedTraining(model, mesh, anchored)
            params = shards.params
        else:
            params = list(model.net.parameters())
        opt = Adam(params, clip=self.gradient_clip_val,
                   weight_decay=weight_decay,
                   sq_norm=None if shards is None else shards.sq_norm)

        # ----- the training kernel's plan (the JAX trainer's dispatch rules)
        fused_cfg = self.trainer_config.get('fused_epochs', True)
        fused_plan = None
        single_net = kind in _SINGLE_NET
        if fused_cfg and not sharded \
                and (device.type == 'cuda' or fused_cfg == 'force') \
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
        drops = ft.drop_rates(model.net).to(device, non_blocking=True)
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
        es_hook = next((h for h in hooks if isinstance(h, EarlyStopping)),
                       None)

        def whole_fit_ok(e0):
            """Every epoch from ``e0`` on may run in one whole-fit
            dispatch: ``whole_fit`` allows it (``True`` or ``'auto'``),
            every hook's validation behaviour can be replayed
            afterwards (one EarlyStopping and any ModelSavingCallback on
            ``val_loss``, no other ``on_validation_end``) and no remaining
            epoch wants batches or a hook between its phases. The JAX
            trainer's ``_whole_fit_ok``."""
            if not self.trainer_config.get('whole_fit', 'auto'):
                return False
            n_es = 0
            for h in hooks:
                if isinstance(h, EarlyStopping):
                    n_es += 1
                    if h.mode != 'min' or h.monitor != 'val_loss':
                        return False
                elif isinstance(h, ModelSavingCallback):
                    if h.monitor != 'val_loss':
                        return False
                elif (type(h).on_validation_end
                      is not TrainerHook.on_validation_end):
                    return False
            if n_es > 1:
                return False
            return all(val_fusion_ok(e)
                       and not any(_wants_batches(h, e) for h in hooks)
                       for e in range(e0, self.max_epochs))

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
            if shards is not None:
                loss = shards.loss(x_train, y_train, idx, dropout_gen,
                                   anchor_perm)
                grads = shards.sync_grads(torch.autograd.grad(
                    loss, params, allow_unused=True))
                opt.step(grads, lr)
                return loss.detach()
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

            if (fused_plan is not None and nb_val_full > 0 and not batch_hooks
                    and not has_tail and full_batches > 0
                    and whole_fit_ok(epoch)):
                # ---- every remaining epoch in one dispatch, then the host
                # replays the logs and hooks from the card's buffers
                self.whole_fit_dispatches += 1
                t0 = time.perf_counter()
                if fused_buffers is None:
                    fused_buffers, fused_step0 = pack_fused()
                dec = DeviceDecisions(device, plateau, es_hook, base_lr,
                                      epoch, self.max_epochs, full_batches,
                                      fused_buffers[0], fused_buffers[3])
                poll = StopPoll(device)
                val_w = self._val_weights(x_val, val_bs, nb_val)
                e0, step0 = epoch, fused_step0

                def enqueue(e):
                    nonlocal perm
                    if shuffle and e % windows == 0 and e != e0:
                        perm = torch.randperm(n, generator=shuffle_gen,
                                              device=device)
                    off = (e % windows) * sample_n
                    idx = perm[off:off + sample_n]
                    run = dec.begin_epoch()
                    if anchored:
                        xs, ys = ft.gather_anchored_epoch_batches(
                            fused_plan, x_train, y_train, idx,
                            self.anchor_permutations(e, 0, full_batches, bs))
                    else:
                        xs, ys = ft.gather_epoch_batches(fused_plan, x_train,
                                                         y_train, idx)
                    *_, losses = ft.fused_epoch(
                        fused_plan, *fused_buffers, xs, ys, dec.lr,
                        step0 + (e - e0) * full_batches,
                        seed=self._epoch_seed(e), drops=drops, stop=dec.stop)
                    unpack_fused(fused_buffers)
                    vl = weighted_mean(self._val_losses(
                        model, x_val, y_val, val_bs, nb_val, e), val_w)
                    dec.end_epoch(e, run, losses, vl, fused_buffers[0],
                                  fused_buffers[3])
                    poll.record(dec.stop)

                t1 = time.perf_counter()
                enqueued = self._enqueue_whole_fit(enqueue, poll, e0)
                t2 = time.perf_counter()
                # the dispatch's one wait for the card
                done = int(dec.done)
                lbuf = dec.losses.cpu().numpy()
                vlbuf = dec.val_losses.cpu().numpy()
                t3 = time.perf_counter()
                trained = done - e0
                self.whole_fit_epochs_lost = enqueued - trained
                ft.uncount_stopped(fused_plan, enqueued - trained, device)
                fused_step0 += trained * full_batches
                unpack_fused(fused_buffers)
                vslice = vlbuf[e0:done]
                argmin_e = int(np.nanargmin(vslice)) + e0 \
                    if done > e0 and not np.all(np.isnan(vslice)) else e0
                for e in range(e0, done):
                    self.current_epoch = e
                    self.fused_epochs_used += 1
                    vl = float(vlbuf[e])
                    self.lr_scales.append(lr_scale)
                    self._log_epoch(lbuf[e], e)
                    for h in hooks:
                        h.on_train_epoch_end(self, model)
                    for h in hooks:
                        h.on_validation_epoch_start(self, model)
                    self.callback_metrics['val_loss'] = vl
                    self.logger.log_metrics({'val_loss': vl, 'epoch': e},
                                            step=self.global_step - 1)
                    if e == argmin_e:
                        # the pinned best parameters, for the hooks that
                        # keep or save the best model
                        unpack_fused([dec.best_theta, None, None,
                                      dec.best_sigma])
                        for h in hooks:
                            h.on_validation_end(self, model,
                                                self.callback_metrics)
                        unpack_fused(fused_buffers)
                    else:
                        # the modules hold the end of the fit here
                        for h in hooks:
                            if not isinstance(h, ModelSavingCallback):
                                h.on_validation_end(self, model,
                                                    self.callback_metrics)
                    lr_scale = plateau.step(vl)
                    self.logger.save()
                # host seconds of the dispatch's parts (observable)
                self.whole_fit_seconds = {
                    'setup': t1 - t0, 'enqueue': t2 - t1, 'drain': t3 - t2,
                    'replay': time.perf_counter() - t3}
                # the card's stop epoch is authoritative
                break

            self.lr_scales.append(lr_scale)
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
                if shards is not None:
                    shards.train_mode()
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
                if shards is not None:
                    shards.eval_mode()
                    if losses:
                        losses = list(shards.global_losses(
                            torch.stack(losses)))
                model.net.eval()
                losses_np = torch.stack(losses).cpu().numpy() if losses \
                    else np.zeros(0, np.float32)

            self._log_epoch(losses_np, epoch)
            for h in hooks:
                h.on_train_epoch_end(self, model)
            for h in hooks:
                h.on_validation_epoch_start(self, model)
            vl = self._weighted_val(model, x_val, y_val, val_bs, nb_val, epoch)
            if sharded:
                # rank 0's value everywhere: every rank decides alike
                vl = mesh.broadcast_object(vl)
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
        # the training kernel's (theta, m, v, sigma) at the end of the fit,
        # or None when the fit ended on the per-step path (observable)
        self.fused_buffers = fused_buffers
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
