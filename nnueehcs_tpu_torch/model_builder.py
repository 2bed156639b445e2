"""Architecture list -> UQ-wrapped model builders.

Counterpart of ``nnueehcs_tpu/model_builder.py`` for the MLP, ensemble,
MC-dropout, Δ-UQ and PAGER builders, with the same architecture rewrites:
MC dropout puts a Dropout before every hidden Linear (the first and last
blocks excluded), Δ-UQ and PAGER double the first layer's input width once.
A built model comes out with parameters drawn from a
``torch.Generator`` seeded with ``seed`` (42 by default, as in the JAX
package) and placed on ``device``. The draws differ from the JAX package's
for the same seed; tests that compare the two copy weights across with
:mod:`nnueehcs_tpu_torch.convert`.
"""
from __future__ import annotations

import copy

import torch

from .models import (PAGERMLP, DeltaUQMLP, EnsembleModel, MCDropoutModel,
                     MLPModel)
from .models.base import resolve_device
from .nn.network import build_network


class ModelBuilder:
    def __init__(self, model_descr, train_config=None, seed=42,
                 device='cuda'):
        self.model_descr = copy.deepcopy(model_descr)
        self.train_config = train_config
        self.seed = seed
        self.device = device

    def _init_model(self, model):
        """Draw the parameters on the CPU (the same numbers on every
        device), then move the model to ``device``."""
        device = resolve_device(self.device)
        model.init(torch.Generator().manual_seed(self.seed))
        return model.to(device)


class MLPModelBuilder(ModelBuilder):
    def build(self):
        model = MLPModel(build_network(self.model_descr),
                         train_config=self.train_config)
        return self._init_model(model)


class EnsembleModelBuilder(ModelBuilder):
    def __init__(self, base_descr, ensemble_descr, **kwargs):
        super().__init__(base_descr, **kwargs)
        self.ensemble_descr = ensemble_descr

    def build(self):
        num_models = self.ensemble_descr['num_models']
        model = EnsembleModel(build_network(self.model_descr,
                                            members=num_models),
                              num_models=num_models,
                              train_config=self.train_config)
        return self._init_model(model)


class _AnchoredBuilder(ModelBuilder):
    """Doubles the first layer's input width, once per builder (the
    anchored input is ``concat([anchor, x - anchor])``)."""
    model_class = None

    def __init__(self, base_descr, uq_descr, **kwargs):
        super().__init__(base_descr, **kwargs)
        self.uq_descr = uq_descr
        self._updated = False

    def build(self):
        if not self._updated:
            self._updated = True
            first = next(iter(self.model_descr[0].values()))
            first['args'][0] = 2 * first['args'][0]
        model = self.model_class(build_network(self.model_descr),
                                 train_config=self.train_config,
                                 **self.uq_descr)
        return self._init_model(model)


class DeltaUQMLPModelBuilder(_AnchoredBuilder):
    model_class = DeltaUQMLP


class PAGERModelBuilder(_AnchoredBuilder):
    model_class = PAGERMLP


class MCDropoutModelBuilder(ModelBuilder):
    def __init__(self, base_descr, dropout_descr, **kwargs):
        super().__init__(base_descr, **kwargs)
        self.dropout_descr = dropout_descr

    @staticmethod
    def _add_dropout(model_descr, dropout_descr):
        """A Dropout before every Linear of the hidden blocks."""
        dropout = {'Dropout': {'args': [dropout_descr['dropout_percent']]}}
        new_model = [model_descr[0]]
        for layer in model_descr[1:-1]:
            if layer.get('Linear') or layer.get('Conv2d'):
                new_model.append(copy.deepcopy(dropout))
            new_model.append(layer)
        new_model.append(model_descr[-1])
        return new_model

    def build(self):
        descr = self._add_dropout(self.model_descr, self.dropout_descr)
        model = MCDropoutModel(build_network(descr),
                               train_config=self.train_config,
                               **self.dropout_descr)
        return self._init_model(model)
