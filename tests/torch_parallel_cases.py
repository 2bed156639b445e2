"""Rank bodies of the multi-process CPU tests (tests/test_torch_parallel_*.py,
tests/test_torch_multihost.py), run by ``nnueehcs_tpu_torch.parallel.launch``
in gloo worlds of CPU ranks. Each spawned rank imports this module, so it
imports neither JAX nor the JAX package: the test files build their inputs
(bundles, arrays) with JAX in the test process and hand them over as
numpy. Every rank runs every case in the same order (each makes the same
meshes), and each returns its answers as numpy arrays."""
import os

import numpy as np
import torch

from nnueehcs_tpu_torch.ops import kde as pkde
from nnueehcs_tpu_torch.parallel import make_mesh, multihost
from nnueehcs_tpu_torch.training import (ArrayDataset, DataLoader,
                                         EarlyStopping, ModelSavingCallback,
                                         Trainer)
from nnueehcs_tpu_torch.training.checkpoint import build_from_bundle

#: a world's own limit (seconds): a hung rank fails its test
WORLD_TIMEOUT = 240


def _np(out):
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


def eval_cases(rank, world_mesh, cases):
    """``cases``: ``(name, kind, spec)``. ``'model'``: ``spec = (bundle,
    axes, x, calls)``, the bundle's model attached to a mesh of ``axes``
    and called ``calls`` times on ``x``; ``'kde'``, ``'knn'``,
    ``'knn_density'``: ``spec = (x, data, h or k, ...)`` through the
    corpus-sharded ops on ``world_mesh``. Returns ``{name: answer}``."""
    out = {}
    for name, kind, spec in cases:
        if kind == 'model':
            bundle, axes, x, calls = spec
            model = build_from_bundle(bundle, device='cpu')
            model.attach_mesh(make_mesh(axes))
            out[name] = [_np(model(x, return_ue=True)) for _ in range(calls)]
        elif kind == 'kde':
            x, data, h = spec
            out[name] = pkde.kde_logpdf_sharded(
                torch.from_numpy(x), torch.from_numpy(data), h,
                world_mesh).numpy()
        elif kind == 'knn':
            x, data, k = spec
            out[name] = pkde.knn_sq_dists_sharded(
                torch.from_numpy(x), torch.from_numpy(data), k,
                world_mesh).numpy()
        else:
            x, data, h, k = spec
            out[name] = pkde.knn_kde_density_sharded(
                torch.from_numpy(x), torch.from_numpy(data), h, k,
                world_mesh).numpy()
    return out


def fit(bundle, cfg, x, y, batch, log_dir, version, device='cpu',
        shuffle=False):
    """One fit of the bundle's model under ``cfg`` (a ``mesh`` in it or
    not); returns the model and its trainer."""
    model = build_from_bundle(bundle, device=device)
    trainer = Trainer('t', cfg, callbacks=[EarlyStopping(patience=100),
                                           ModelSavingCallback()]
                      + model.get_callbacks(),
                      log_dir=log_dir, version=version, device=device)
    trainer.fit(model,
                DataLoader(ArrayDataset(x, y), batch, shuffle=shuffle,
                           drop_last=True),
                DataLoader(ArrayDataset(x, y), batch))
    return model, trainer


def train_cases(rank, world_mesh, cases, log_dir):
    """``cases``: ``(name, bundle, cfg, x, y, batch, shuffle)``; each fit
    runs on every rank (``cfg['mesh']`` names the axes). Returns ``{name:
    {...}}``: the validation loss, the model's answers on ``x`` after the
    fit (sharded), the gathered arrays and what this rank wrote."""
    out = {}
    for name, bundle, cfg, x, y, batch, shuffle in cases:
        model, trainer = fit(bundle, cfg, x, y, batch, log_dir, name,
                             shuffle=shuffle)
        pred = model(x, return_ue=getattr(model, 'uq_method', '') != 'mlp')
        arrays = model.arrays_dict()
        world_mesh.barrier()
        out[name] = {
            'val_loss': trainer.callback_metrics['val_loss'],
            'train_loss': trainer.callback_metrics.get('train_loss'),
            'pred': _np(pred),
            'arrays': {'params': arrays['params'], 'state': arrays['state']},
            'log_dir': trainer.logger.log_dir,
            'files': sorted(os.listdir(trainer.logger.log_dir)),
            'fused_epochs_used': trainer.fused_epochs_used,
        }
    return out


def multihost_case(rank, mesh, port):
    """``initialize`` again (a no-op, as in JAX), ``process_info``, and a
    sum over both processes."""
    multihost.initialize(f'127.0.0.1:{port}', 2, rank)
    multihost.initialize(f'127.0.0.1:{port}', 2, rank)
    total = mesh.all_reduce(torch.tensor([float(rank + 1)]), 'dp')
    return {'info': multihost.process_info(),
            'multihost': multihost.is_multihost(),
            'total': float(total.item()),
            'gathered': mesh.all_gather(torch.tensor([rank]), 'dp').tolist(),
            'device': mesh.device}


def failing_case(rank, mesh):
    if rank == 1:
        raise KeyError('rank 1 fails on purpose')
    mesh.barrier()


def sleeping_case(rank, mesh):
    import time
    time.sleep(WORLD_TIMEOUT)



def _card_arch(width=64, hidden=3):
    arch, fan_in = [], 5
    for _ in range(hidden):
        arch += [{'Linear': {'args': [fan_in, width]}},
                 {'BatchNorm1d': {'args': [width]}}, {'ReLU': {}}]
        fan_in = width
    return arch + [{'Linear': {'args': [fan_in, 1]}}]


def card_cases(rank, mesh, rows):
    """A gloo world on the card: each model unsharded on this rank, then
    dp-sharded over the world (every rank the same request); returns
    ``{name: (unsharded, sharded, launches of the sharded call)}``."""
    from nnueehcs_tpu_torch.model_builder import (EnsembleModelBuilder,
                                                  KDEModelBuilder,
                                                  MCDropoutModelBuilder)
    from nnueehcs_tpu_torch.ops.fused_ensemble import fused_forward_prefolded
    from nnueehcs_tpu_torch.ops.fused_mc_dropout import fused_mc_forward
    from nnueehcs_tpu_torch.ops.kde import kde_logpdf
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = {'fused_ensemble': fused_forward_prefolded,
                'fused_mc_dropout': fused_mc_forward, 'kde': kde_logpdf}
    rng = np.random.default_rng(11)
    x = rng.normal(size=(rows, 5)).astype(np.float32)
    corpus = rng.normal(size=(4096, 5)).astype(np.float32)
    makers = {
        'fused_ensemble': lambda: EnsembleModelBuilder(
            _card_arch(), {'num_models': 4}, seed=3,
            device=mesh.device).build(),
        'fused_mc_dropout': lambda: MCDropoutModelBuilder(
            _card_arch(), {'num_samples': 32, 'dropout_percent': 0.2},
            seed=3, device=mesh.device).build(),
        'kde': lambda: KDEModelBuilder(_card_arch(), {'rtol': 1000}, seed=3,
                                       device=mesh.device).build(),
    }
    out = {}
    for name, make in makers.items():
        models = []
        for attach in (False, True):
            model = make()
            if name == 'kde':
                model.fit_kde(corpus)
            if attach:
                model.attach_mesh(mesh)
            models.append(model)
        want = _np(tuple(t.cpu() for t in models[0](x, return_ue=True)))
        for wrapper in counters.values():
            wrapper.launches = 0
        got = _np(tuple(t.cpu() for t in models[1](x, return_ue=True)))
        out[name] = (want, got, {k: w.launches for k, w in counters.items()})
    return out


def nccl_sum(rank, mesh):
    """The world's sum of rank + 1 over the default group, and the device."""
    import torch.distributed as dist
    total = torch.tensor([float(rank + 1)], device=mesh.device)
    dist.all_reduce(total)
    return float(total.item()), str(mesh.device)
