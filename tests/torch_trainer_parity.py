"""Shared set-up of the tests that hold the port's Trainer
(``nnueehcs_tpu_torch.training``) against the JAX package's on the same
converted init, on the CPU (tests/test_torch_trainer*.py).

Both run with ``fused_epochs: 'force'`` (the JAX kernel in interpret mode,
the port's plain epoch), ``whole_fit: False``, ``shuffle=False`` and
``drop_last=True`` (the two shuffle streams differ by design), so every
epoch sees the same batches in the same order.

Tolerances: per-step training losses of kernel epochs 1e-5 (the kernel
epochs agree to float32 round-off, tests/test_torch_fused_train.py);
anything after a per-step epoch, and val_loss everywhere, 1e-3 absolute
(the bar the JAX package holds its own kernel and scan paths to,
tests/test_fused_train.py:256-266) plus 1e-3 relative (the MVE NLL runs
near 1 and divides by the predicted variance): a gradient that sums to exactly zero
in one package and to a rounding error in the other moves a parameter by
a fraction of lr through Adam, and the Linear biases that BatchNorm
cancels move by up to lr a step on the sign of a rounding error. Each
parameter's change over the fit (theta_end - theta_0, about 1.7e-2 for
most) is held to JAX's within 1e-6, ten times the largest difference
measured on these fits (1.2e-7); the BatchNorm-cancelled Linear biases,
whose changes are two independent walks on rounding noise, within 1.5e-2
(measured up to 1.06e-2, on the MVE fit; two such walks of 18 Adam steps
can differ by up to 3.6e-2). BatchNorm running variances 5e-3
(tests/test_fused_train.py:108-115); running means, which follow those
biases, 2e-2. MC-dropout
validation draws each package's own MC samples, so only its training
losses are compared (the kernel's dropout masks are the same hash in
both)."""
import csv
import os

import numpy as np

from nnueehcs_tpu import model_builder as jmb
from nnueehcs_tpu import training as jtr
from nnueehcs_tpu_torch import training as ptr
from nnueehcs_tpu_torch.convert import to_pytrees
from nnueehcs_tpu_torch.nn.layers import BatchNorm1d

from torch_parity import descr, port_of, randomize_params, randomize_state

TIGHT = {'rtol': 0, 'atol': 1e-5}
LOOSE = {'rtol': 1e-3, 'atol': 1e-3}
DELTA_ATOL = 1e-6               # parameter changes over a fit
CANCELLED_BIAS_DELTA_ATOL = 1.5e-2
N, BS = 96, 16


def data(n=N, d=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(x).sum(1, keepdims=True)
         + 0.1 * rng.normal(size=(n, 1))).astype(np.float32)
    return x, y


def jax_model(family):
    tc = {'loss': 'l1_loss'}
    if family == 'ensemble_per_member':
        tc['ensemble_loss'] = 'per_member'
    arch = descr()
    if family.startswith('ensemble'):
        m = jmb.EnsembleModelBuilder(arch, {'num_models': 2},
                                     train_config=tc).build()
    elif family == 'mve':
        m = jmb.MVEModelBuilder(arch, {}, train_config=tc).build()
    elif family == 'kde':
        m = jmb.KDEModelBuilder(arch, {'rtol': 1000}, train_config=tc).build()
    else:
        m = jmb.MCDropoutModelBuilder(descr(hidden=3), {
            'num_samples': 4, 'dropout_percent': 0.2}, train_config=tc).build()
    m.params = randomize_params(m.params, 1)
    m.state = randomize_state(m.state, 2)
    m.invalidate_cache()
    return m


def rows(trainer):
    with open(os.path.join(trainer.logger.log_dir, 'metrics.csv')) as f:
        return list(csv.DictReader(f))


def column(rows, key):
    return np.array([float(r[key]) for r in rows if r.get(key)])


def fit_both(tmp_path, family, cfg=None, callbacks=None, n=N,
              drop_last=True):
    """Fit the JAX model and its port on the same data and config; returns
    (jax model, jax trainer, port model, port trainer)."""
    x, y = data(n)
    jm = jax_model(family)
    # a host copy: the JAX trainer may donate the initial arrays
    jm.params_before_fit = [{k: np.array(v) for k, v in p.items()}
                            for p in jm.params]
    pm = port_of(jm)
    config = {'accelerator': 'cpu', 'max_epochs': 3, 'gradient_clip_val': 5.0,
              'fused_epochs': 'force', 'whole_fit': False,
              'log_every_n_steps': 1, **(cfg or {})}
    make = callbacks or (lambda pkg, m: [pkg.EarlyStopping(patience=10),
                                         pkg.ModelSavingCallback()]
                         + m.get_callbacks())
    jt = jtr.Trainer('t', config, callbacks=make(jtr, jm),
                     log_dir=str(tmp_path), version='jax')
    jt.fit(jm, jtr.DataLoader(jtr.ArrayDataset(x, y), BS, shuffle=False,
                              drop_last=drop_last),
           jtr.DataLoader(jtr.ArrayDataset(x, y), BS))
    pt = ptr.Trainer('t', config, callbacks=make(ptr, pm),
                     log_dir=str(tmp_path), version='port', device='cpu')
    pt.fit(pm, ptr.DataLoader(ptr.ArrayDataset(x, y), BS, shuffle=False,
                              drop_last=drop_last),
           ptr.DataLoader(ptr.ArrayDataset(x, y), BS))
    return jm, jt, pm, pt


def assert_params_close(jm, pm):
    """Each parameter's change over the fit equals JAX's (the Linear
    biases that a BatchNorm cancels within their noise bound), and the
    BatchNorm running statistics agree."""
    params, state = to_pytrees(pm.net)
    layers = list(pm.net.layers)
    for i, (a, b, a0) in enumerate(zip(jm.params, params,
                                       jm.params_before_fit)):
        for key in a:
            cancelled = (key == 'b' and i + 1 < len(layers)
                         and isinstance(layers[i + 1], BatchNorm1d))
            np.testing.assert_allclose(
                b[key] - a0[key], np.asarray(a[key]) - a0[key], rtol=0,
                atol=CANCELLED_BIAS_DELTA_ATOL if cancelled else DELTA_ATOL,
                err_msg=f'layer {i} {key}: change over the fit')
    for a, b in zip(jm.state, state):
        if a:
            # a running mean follows the batch means of x W + b, so it moves
            # with the BatchNorm-cancelled bias b (parameter tolerance)
            np.testing.assert_allclose(b['mean'], np.asarray(a['mean']),
                                       rtol=0, atol=2e-2)
            np.testing.assert_allclose(b['var'], np.asarray(a['var']),
                                       rtol=0, atol=5e-3)
