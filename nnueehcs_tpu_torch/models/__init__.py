"""UQ model wrappers (counterpart of ``nnueehcs_tpu/models``): every class
the JAX package's ``MODEL_CLASSES`` names."""
from .base import WrappedModelBase, training_defaults
from .delta_uq import DeltaUQMLP
from .ensemble import EnsembleModel
from .kde import KDEMLPModel, KNNKDEMLPModel
from .mc_dropout import MCDropoutModel
from .mlp import MLPModel
from .mve import MVEMLPModel
from .pager import PAGERMLP

MODEL_CLASSES = {
    'MLPModel': MLPModel,
    'EnsembleModel': EnsembleModel,
    'MCDropoutModel': MCDropoutModel,
    'DeltaUQMLP': DeltaUQMLP,
    'PAGERMLP': PAGERMLP,
    'KDEMLPModel': KDEMLPModel,
    'KNNKDEMLPModel': KNNKDEMLPModel,
    'MVEMLPModel': MVEMLPModel,
}


def model_class(name: str):
    """The wrapper class a bundle names; a name outside
    ``MODEL_CLASSES`` raises ``NotImplementedError``."""
    try:
        return MODEL_CLASSES[name]
    except KeyError:
        raise NotImplementedError(
            f'model class {name!r} is not ported to PyTorch yet') from None


__all__ = ['WrappedModelBase', 'MLPModel', 'EnsembleModel', 'MCDropoutModel',
           'DeltaUQMLP', 'PAGERMLP', 'KDEMLPModel', 'KNNKDEMLPModel',
           'MVEMLPModel', 'MODEL_CLASSES', 'model_class', 'training_defaults']
