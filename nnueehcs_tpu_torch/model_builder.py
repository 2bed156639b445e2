"""Architecture list -> UQ-wrapped model builders.

Counterpart of ``nnueehcs_tpu/model_builder.py`` for the MLP and ensemble
builders. A built model comes out with parameters drawn from a
``torch.Generator`` seeded with ``seed`` (42 by default, as in the JAX
package) and placed on ``device``. The draws differ from the JAX package's
for the same seed; tests that compare the two copy weights across with
:mod:`nnueehcs_tpu_torch.convert`.
"""
from __future__ import annotations

import copy

import torch

from .models import EnsembleModel, MLPModel
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
