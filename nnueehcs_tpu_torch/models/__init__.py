"""UQ model wrappers ported so far (counterpart of
``nnueehcs_tpu/models``)."""
from .base import WrappedModelBase, training_defaults
from .ensemble import EnsembleModel
from .mlp import MLPModel

MODEL_CLASSES = {
    'MLPModel': MLPModel,
    'EnsembleModel': EnsembleModel,
}


def model_class(name: str):
    """The wrapper class a bundle names; the JAX package's other classes
    are not ported yet."""
    try:
        return MODEL_CLASSES[name]
    except KeyError:
        raise NotImplementedError(
            f'model class {name!r} is not ported to PyTorch yet') from None


__all__ = ['WrappedModelBase', 'MLPModel', 'EnsembleModel', 'MODEL_CLASSES',
           'model_class', 'training_defaults']
