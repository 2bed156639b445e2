"""Trainer callbacks: early stopping and best-model checkpointing.

Counterpart of ``nnueehcs_tpu/training/callbacks.py`` (the Lightning
behaviours the reference relies on, reference
``nnueehcs/training.py:16-18, 41-65``).
"""
from __future__ import annotations

import math
import os

from .checkpoint import save_model
from .hooks import TrainerHook


class EarlyStopping(TrainerHook):
    """Stop when the monitored metric has not improved by ``min_delta`` for
    ``patience`` validation epochs (Lightning defaults: patience 3,
    min_delta 0, mode 'min')."""

    def __init__(self, monitor: str = 'val_loss', min_delta: float = 0.0,
                 patience: int = 3, verbose: bool = False, mode: str = 'min'):
        self.monitor = monitor
        self.min_delta = abs(min_delta)
        self.patience = patience
        self.verbose = verbose
        self.mode = mode
        self.wait_count = 0
        self.best_score = math.inf if mode == 'min' else -math.inf
        self.stopped_epoch = 0

    def _improved(self, current) -> bool:
        if self.mode == 'min':
            return current < self.best_score - self.min_delta
        return current > self.best_score + self.min_delta

    def on_validation_end(self, trainer, model, metrics):
        current = metrics.get(self.monitor)
        if current is None:
            return
        if self._improved(current):
            self.best_score = current
            self.wait_count = 0
        else:
            self.wait_count += 1
            if self.wait_count >= self.patience:
                trainer.should_stop = True
                self.stopped_epoch = trainer.current_epoch
                if self.verbose:
                    print(f'EarlyStopping: stopping at epoch '
                          f'{trainer.current_epoch}')


class ModelSavingCallback(TrainerHook):
    """Save the model bundle whenever the monitored metric improves
    (reference ``nnueehcs/training.py:41-65``), as ``model.pth`` by default.

    ``defer_serialization=True`` only pins a device-side copy of the
    winning parameters and buffers at each improvement and writes the
    bundle once, at the end of the fit: no host transfer per improving
    epoch, at the cost of no file for an interrupted fit.
    """

    def __init__(self, monitor: str = 'val_loss', save_path=None,
                 model_name: str = 'model.pth',
                 defer_serialization: bool = False):
        self.monitor = monitor
        self.save_path = save_path
        self.model_name = model_name
        self.defer_serialization = defer_serialization
        self._pinned = None

    def on_fit_start(self, trainer, model):
        self.trainer = trainer
        if self.save_path is None:
            self.save_path = trainer.logger.log_dir

    def on_validation_end(self, trainer, model, metrics):
        if self.monitor not in metrics:
            return
        current = metrics[self.monitor]
        if not hasattr(self, 'best') or current < self.best:
            self.best = current
            if self.defer_serialization:
                self._pinned = {k: t.detach().clone()
                                for k, t in model.net.state_dict().items()}
            else:
                self.save_checkpoint(model)

    def on_fit_end(self, trainer, model):
        if self.defer_serialization and self._pinned is not None:
            live = {k: t.detach().clone()
                    for k, t in model.net.state_dict().items()}
            model.net.load_state_dict(self._pinned)
            try:
                self.save_checkpoint(model)
            finally:
                model.net.load_state_dict(live)

    def save_checkpoint(self, model):
        os.makedirs(self.save_path, exist_ok=True)
        save_model(model, os.path.join(self.save_path, self.model_name))
