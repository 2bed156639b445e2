"""Trainer hooks (the reference's Lightning callbacks, made explicit).

Counterpart of ``nnueehcs_tpu/training/hooks.py``: the hook points the
trainer calls, the KDE and kNN-KDE fit hooks that observe the epoch-0
training batches, and the Δ-UQ and PAGER hooks that capture anchors from
them.
"""
from __future__ import annotations

import numpy as np


class TrainerHook:
    """Hook points mirroring the Lightning callback surface the reference
    relies on."""

    def on_fit_start(self, trainer, model):
        pass

    def on_train_batch_end(self, trainer, model, batch, batch_idx):
        pass

    def on_train_epoch_end(self, trainer, model):
        pass

    def on_validation_epoch_start(self, trainer, model):
        pass

    def on_validation_end(self, trainer, model, metrics):
        pass

    def on_fit_end(self, trainer, model):
        pass

    def fusion_quiescent(self, epoch) -> bool:
        """True when, for ``epoch``, this hook will not change the model in
        ``on_train_epoch_end`` or ``on_validation_epoch_start``, so the
        trainer may run the epoch through the training kernel. Default:
        quiescent unless the hook overrides one of those points."""
        cls = type(self)
        return (cls.on_validation_epoch_start
                is TrainerHook.on_validation_epoch_start
                and cls.on_train_epoch_end is TrainerHook.on_train_epoch_end)


class EpochZeroFitHook(TrainerHook):
    """Base of the fit hooks: they read epoch-0 training batches (data
    only, so the trainer may deliver them after the epoch) and change the
    model once, at the end of that epoch."""

    batch_data_only = True

    def __init__(self):
        self._train_data_to_fit = []
        self._epochs = 0

    def fusion_quiescent(self, epoch):
        # quiescent for good once the epoch-0 fit is done
        return self._epochs >= 1


class KDEFitHook(EpochZeroFitHook):
    """Keep the epoch-0 training inputs and fit the KDE at the end of
    epoch 0 (reference ``nnueehcs/models.py:225-240``)."""

    def on_train_batch_end(self, trainer, model, batch, batch_idx):
        if self._epochs == 0:
            self._train_data_to_fit.append(np.asarray(batch[0]))

    def on_train_epoch_end(self, trainer, model):
        print(f'Fitting KDE on {len(self._train_data_to_fit)} batches')
        if self._epochs == 0:
            model.fit_kde(np.concatenate(self._train_data_to_fit))
        self._epochs += 1


class KNNKDEFitHook(EpochZeroFitHook):
    """The same capture; the fit happens at the first validation-epoch
    start (reference ``nnueehcs/models.py:267-281``)."""

    def on_train_batch_end(self, trainer, model, batch, batch_idx):
        if self._epochs == 0:
            self._train_data_to_fit.append(np.asarray(batch[0]))

    def on_validation_epoch_start(self, trainer, model):
        if self._epochs == 0 and self._train_data_to_fit:
            model.fit_kde(np.concatenate(self._train_data_to_fit))
        self._epochs += 1


class DeltaUQGetAnchorsHook(EpochZeroFitHook):
    """Capture the first ``num_anchors`` training inputs during epoch 0 and
    install them as anchors before the first validation epoch (reference
    ``nnueehcs/models.py:354-369``)."""

    def on_train_batch_end(self, trainer, model, batch, batch_idx):
        bs = np.asarray(batch[0]).shape[0]
        if self._epochs == 0 and \
                bs * len(self._train_data_to_fit) < model.num_anchors:
            self._train_data_to_fit.append(np.asarray(batch[0]))

    def on_validation_epoch_start(self, trainer, model):
        if self._epochs == 0 and self._train_data_to_fit:
            data = np.concatenate(self._train_data_to_fit)
            model.anchors = data[:model.num_anchors]
        self._epochs += 1


class PAGERGetAnchorsHook(EpochZeroFitHook):
    """Like :class:`DeltaUQGetAnchorsHook`, also capturing the anchors'
    targets (reference ``nnueehcs/models.py:450-472``)."""

    def __init__(self):
        super().__init__()
        self._anchor_X = []
        self._anchor_Y = []

    def on_train_batch_end(self, trainer, model, batch, batch_idx):
        bs = np.asarray(batch[0]).shape[0]
        if self._epochs == 0 and bs * len(self._anchor_X) < model.num_anchors:
            self._anchor_X.append(np.asarray(batch[0]))
            self._anchor_Y.append(np.asarray(batch[1]))

    def on_validation_epoch_start(self, trainer, model):
        if self._epochs == 0 and self._anchor_X:
            n = model.num_anchors
            model.anchors = np.concatenate(self._anchor_X)[:n]
            model.anchors_Y = np.concatenate(self._anchor_Y)[:n]
        self._epochs += 1
