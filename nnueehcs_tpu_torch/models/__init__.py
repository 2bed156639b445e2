"""UQ model wrappers ported so far (counterpart of
``nnueehcs_tpu/models``)."""
from .base import WrappedModelBase, training_defaults
from .delta_uq import DeltaUQMLP
from .ensemble import EnsembleModel
from .mc_dropout import MCDropoutModel
from .mlp import MLPModel
from .pager import PAGERMLP

MODEL_CLASSES = {
    'MLPModel': MLPModel,
    'EnsembleModel': EnsembleModel,
    'MCDropoutModel': MCDropoutModel,
    'DeltaUQMLP': DeltaUQMLP,
    'PAGERMLP': PAGERMLP,
}


def model_class(name: str):
    """The wrapper class a bundle names; the JAX package's other classes
    are not ported yet."""
    try:
        return MODEL_CLASSES[name]
    except KeyError:
        raise NotImplementedError(
            f'model class {name!r} is not ported to PyTorch yet') from None


__all__ = ['WrappedModelBase', 'MLPModel', 'EnsembleModel', 'MCDropoutModel',
           'DeltaUQMLP', 'PAGERMLP', 'MODEL_CLASSES', 'model_class',
           'training_defaults']
