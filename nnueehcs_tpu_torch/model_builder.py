"""Architecture list -> UQ-wrapped model builders.

Counterpart of ``nnueehcs_tpu/model_builder.py``: one builder per UQ
method, with the same architecture rewrites. MC dropout puts a Dropout
before every hidden Linear (the first and last blocks excluded); Δ-UQ and
PAGER double the first layer's input width, and MVE the last layer's
output width, once per builder. ``get_info()`` gives the info grabber of
the (rewritten) architecture with the method's accessors installed by
``update_info``, as in the JAX package. A built model comes out with
parameters drawn from a
``torch.Generator`` seeded with ``seed`` (42 by default, as in the JAX
package) and placed on ``device``. The draws differ from the JAX package's
for the same seed; tests that compare the two copy weights across with
:mod:`nnueehcs_tpu_torch.convert`.
"""
from __future__ import annotations

import copy

import torch

from .models import (PAGERMLP, DeltaUQMLP, EnsembleModel, KDEMLPModel,
                     KNNKDEMLPModel, MCDropoutModel, MLPModel, MVEMLPModel)
from .models.base import resolve_device
from .nn.network import build_network


class InfoGrabbBase:
    def __init__(self, descr):
        self.descr = descr

    def num_layers(self):
        return len(self.descr)


class CNNInfoGrabber(InfoGrabbBase):
    def is_cnn(self):
        return True

    def is_mlp(self):
        return False

    def num_inputs(self):
        return self.descr[0]['Conv2d']['args'][0]

    def set_num_inputs(self, num_inputs):
        self.descr[0]['Conv2d']['args'][0] = num_inputs


class MLPInfoGrabber(InfoGrabbBase):
    def is_mlp(self):
        return True

    def is_cnn(self):
        return False

    def num_inputs(self):
        return self.descr[0]['Linear']['args'][0]

    def set_num_inputs(self, num_inputs):
        self.descr[0]['Linear']['args'][0] = num_inputs


class ModelInfo:
    @classmethod
    def get_info_grabber(cls, model_descr):
        if 'Conv2d' in model_descr[0]:
            return CNNInfoGrabber(model_descr)
        return MLPInfoGrabber(model_descr)


class ModelBuilder:
    def __init__(self, model_descr, train_config=None, seed=42,
                 device='cuda'):
        self.model_descr = copy.deepcopy(model_descr)
        self.train_config = train_config
        self.seed = seed
        self.device = device

    def update_info(self, info):
        """Install the method's accessors on ``info`` (and rewrite the
        architecture where the method does, once)."""
        return info

    def get_info(self):
        info = ModelInfo.get_info_grabber(self.model_descr)
        self.update_info(info)
        return info

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

    def update_info(self, info):
        num_models = self.ensemble_descr['num_models']
        info.get_num_models = lambda: num_models


class _AnchoredBuilder(ModelBuilder):
    """Doubles the first layer's input width, once per builder (the
    anchored input is ``concat([anchor, x - anchor])``)."""
    model_class = None

    def __init__(self, base_descr, uq_descr, **kwargs):
        super().__init__(base_descr, **kwargs)
        self.uq_descr = uq_descr
        self._updated = False

    def build(self):
        self.get_info()
        model = self.model_class(build_network(self.model_descr),
                                 train_config=self.train_config,
                                 **self.uq_descr)
        return self._init_model(model)

    def update_info(self, info):
        estimator = self.uq_descr.get('estimator', 'std')
        info.get_estimator = lambda: estimator
        if self._updated:
            return
        self._updated = True
        info.set_num_inputs(2 * info.num_inputs())


class DeltaUQMLPModelBuilder(_AnchoredBuilder):
    model_class = DeltaUQMLP

    def update_info(self, info):
        batch_size = self.uq_descr.get('anchored_batch_size')
        info.get_batch_size = lambda: batch_size
        super().update_info(info)


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

    def update_info(self, info):
        num_samples = self.dropout_descr['num_samples']
        dropout_percent = self.dropout_descr['dropout_percent']
        info.get_num_samples = lambda: num_samples
        info.get_dropout_percent = lambda: dropout_percent


class MVEModelBuilder(ModelBuilder):
    """Mean-variance estimation: doubles the last layer's output width
    (``(mu, raw)``), once per builder."""

    def __init__(self, base_descr, mve_descr=None, **kwargs):
        super().__init__(base_descr, **kwargs)
        self.mve_descr = dict(mve_descr or {})
        self._updated = False

    def build(self):
        self.get_info()
        model = MVEMLPModel(build_network(self.model_descr),
                            train_config=self.train_config, **self.mve_descr)
        return self._init_model(model)

    def update_info(self, info):
        if self._updated:
            return
        self._updated = True
        last = next(iter(self.model_descr[-1].values()))
        last['args'][1] = 2 * last['args'][1]


class _DensityBuilder(ModelBuilder):
    """A plain MLP wrapped with a density-scored UE; the corpus comes later,
    from ``model.fit_kde(data)`` or a bundle."""
    model_class = None

    def __init__(self, base_descr, density_descr, **kwargs):
        super().__init__(base_descr, **kwargs)
        self.density_descr = density_descr

    def build(self):
        model = self.model_class(build_network(self.model_descr),
                                 train_config=self.train_config,
                                 **self.density_descr)
        return self._init_model(model)


class KDEModelBuilder(_DensityBuilder):
    model_class = KDEMLPModel


class KNNKDEModelBuilder(_DensityBuilder):
    model_class = KNNKDEMLPModel
