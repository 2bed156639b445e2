"""Training (counterpart of ``nnueehcs_tpu/training``): the trainer, its
data loader, hooks, callbacks and CSV logger, and ``model.pth`` bundles."""
from .callbacks import EarlyStopping, ModelSavingCallback
from .checkpoint import FORMAT, build_from_bundle, load_model, save_model
from .data import ArrayDataset, DataLoader
from .hooks import (DeltaUQGetAnchorsHook, KDEFitHook, KNNKDEFitHook,
                    PAGERGetAnchorsHook, TrainerHook)
from .loggers import CSVLogger
from .trainer import PlateauScheduler, Trainer

__all__ = ['Trainer', 'PlateauScheduler', 'EarlyStopping',
           'ModelSavingCallback', 'save_model', 'load_model',
           'build_from_bundle', 'FORMAT', 'DataLoader', 'ArrayDataset',
           'TrainerHook', 'KDEFitHook', 'KNNKDEFitHook',
           'DeltaUQGetAnchorsHook', 'PAGERGetAnchorsHook', 'CSVLogger']
