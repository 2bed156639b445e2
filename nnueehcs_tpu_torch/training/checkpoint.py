"""``model.pth`` bundles: save and load.

Counterpart of ``nnueehcs_tpu/training/checkpoint.py`` for the
``nnueehcs_tpu-ckpt-v1`` pickle bundle: ``{'format', 'config', 'arrays'}``
where ``config`` is the wrapper's constructor config (architecture
included) and ``arrays`` holds the weights as numpy arrays in the JAX
package's layout. Either package reads the other's bundles. The JAX
package's Orbax directory format is not ported.
"""
from __future__ import annotations

import os
import pickle

FORMAT = 'nnueehcs_tpu-ckpt-v1'


class _BundleUnpickler(pickle.Unpickler):
    """Unpickles numpy arrays and plain Python values only. Bundles written
    under numpy 2 name ``numpy._core``, which numpy 1 calls ``numpy.core``."""

    def find_class(self, module, name):
        if module != 'numpy' and not module.startswith('numpy.'):
            raise pickle.UnpicklingError(
                f'unexpected global {module}.{name} in a model bundle')
        if module.startswith('numpy._core'):
            try:
                __import__(module)
            except ImportError:
                module = 'numpy.core' + module[len('numpy._core'):]
        return super().find_class(module, name)


def save_model(model, path: str):
    """Write ``model``'s bundle to ``path``. On a mesh every rank calls it
    (the arrays may be gathered from the ranks) and rank 0 writes."""
    bundle = {
        'format': FORMAT,
        'config': model.config_dict(),
        'arrays': model.arrays_dict(),
    }
    mesh = getattr(model, 'mesh', None)
    if mesh is not None and mesh.rank != 0:
        return
    with open(path, 'wb') as f:
        pickle.dump(bundle, f)


def load_model(path: str, device='cuda'):
    """Rebuild a model from a bundle and place it on ``device``."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f'{path} is a directory: Orbax checkpoints are not ported')
    with open(path, 'rb') as f:
        bundle = _BundleUnpickler(f).load()
    if bundle.get('format') != FORMAT:
        raise ValueError(f'Not a {FORMAT} checkpoint: {path}')
    return build_from_bundle(bundle, device=device)


def build_from_bundle(bundle: dict, device='cuda'):
    from ..models import model_class
    from ..models.base import resolve_device
    from ..nn.network import build_network

    device = resolve_device(device)
    config = dict(bundle['config'])
    cls = model_class(config.pop('class'))
    config.pop('uq_method', None)
    net = build_network(config.pop('architecture'),
                        members=config.get('num_models'))
    model = cls(net, **config)
    model.load_arrays(bundle['arrays'])
    return model.to(device)
