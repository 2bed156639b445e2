"""The port's Trainer in bf16-mixed against the JAX package's, on the CPU,
from the same JAX-built weights (``tests/torch_trainer_parity.py``'s set-up:
``whole_fit: False``, ``shuffle=False``, the JAX kernel in interpret mode),
and the JAX trainer's precision dispatch rules case by case.

The two paths compute different bf16 functions, in JAX as in the port: the
kernel's bf16 form rounds the gradient ``d`` at its products and keeps
BatchNorm in fp32; the per-step path is autograd through the bf16 module
walk. Each is held to its own JAX counterpart:

- kernel epochs (``fused_epochs: 'force'``): the per-step training losses
  agree to fp32 round-off but for a rare bf16 rounding flip, so the first
  10 steps are held to the bf16 bars (``attrib.bf16_close`` against JAX's
  own bf16-vs-fp32 gap) and every step within the gap's max;
- per-step epochs (``fused_epochs: False``): the first loss is the same
  bf16 forward in both (TIGHT); after it the two part at the gap's own
  size, because XLA's CPU fusions keep fp32 between the elementwise ops of
  the BatchNorm backward that torch rounds one at a time (one step's
  parameter gradients measured 0.03-0.23 of the bf16-vs-fp32 gradient gap,
  rms; the loss curves' largest distance 0.91 (ensemble) and 0.98 (MVE) of
  the curves' largest bf16-vs-fp32 gap), so no step may stray farther from
  JAX's bf16 curve than GAP_FACTOR times the largest gap;
- validation losses within GAP_FACTOR times the largest gap of JAX's
  validation curve (measured 0.9-1.1 of it): the ensemble's bf16 validation
  runs the folded kernel 1b function in the port and the module walk in
  JAX (the deliberate difference of ROADMAP §3), and the BatchNorm-cancelled
  biases, which the bf16 rounding of a Linear output sees, walk apart
  (below); MC dropout's validation draws each package's own samples and is
  not compared;
- each parameter's change over the fit (about 1e-2 rms): on kernel
  epochs alone, to the bf16 bars against JAX's own bf16-vs-fp32 change
  (or within the fp32 parity bar, 1e-6, where that gap is 0; measured at
  most 0.011 of the gap); on fits with per-step epochs, whose trajectories
  part at the gap's size, the error's rms within REL_CHANGE of the change's
  own rms (measured at most 0.046), so a fit that moved a parameter too
  little or too far fails; a BatchNorm-cancelled Linear bias, whose
  gradient is rounding noise at every step, within the reach of two walks
  of up to lr a step either way over the fit's 18 steps (3.6e-2; measured
  2.1e-2 on the per-step ensemble fit); running statistics as the fp32
  parity tests hold them (means 2e-2, variances 5e-3);
- the per-step path's bf16 gradient, one step from the same weights: the
  error against JAX's bf16 gradient over every parameter but the
  BatchNorm-cancelled biases, to the bf16 bars against JAX's own
  bf16-vs-fp32 gradient gap (measured 0.009-0.095 of its rms); a step
  whose ops round their outputs to bf16 but keep their cotangents in fp32
  measured 0.24-0.27 on the ensemble and MVE, a step wholly in fp32 1.0.
"""
import os

import numpy as np
import pytest
import torch

from nnueehcs_tpu import training as jtr
from nnueehcs_tpu_torch import training as ptr
from nnueehcs_tpu_torch.attrib import bf16_close
from nnueehcs_tpu_torch.convert import to_pytrees
from nnueehcs_tpu_torch.nn.layers import BatchNorm1d
from nnueehcs_tpu_torch.ops import fused_train as pft
from nnueehcs_tpu_torch.serving import Predictor

from torch_trainer_parity import (BS, DELTA_ATOL, LOOSE, TIGHT, column,
                                  data, fit_both, jax_model, rows)
from torch_parity import port_of

REL_CHANGE = 0.1
TOL_CANCELLED = {'rtol': 0, 'atol': 2 * 1e-3 * 18}
CURVE_CHECKED = 10
GAP_FACTOR = 2.0
BF16 = 'bf16-mixed'


def _losses(trainer, key='train_loss'):
    return column(rows(trainer), key)


def _within_gap(got, want, want32, factor=GAP_FACTOR):
    err, gap = np.abs(got - want), np.abs(want - want32)
    assert err.max() <= factor * gap.max(), (err, gap)


def _cancelled(pm, i, key):
    layers = list(pm.net.layers)
    return (key == 'b' and i + 1 < len(layers)
            and isinstance(layers[i + 1], BatchNorm1d))


def _assert_changes_close(jm, pm, jm_before, jm32=None):
    """Each parameter's change over the fit against JAX's: with ``jm32``,
    JAX's fp32 fit of a run on kernel epochs alone, to the bf16 bars
    against JAX's bf16-vs-fp32 change; without it (fits with per-step
    epochs), relative to the change's own size. Running statistics as the
    fp32 parity tests hold them."""
    params, state = to_pytrees(pm.net)
    for i, (a, b, a0) in enumerate(zip(jm.params, params, jm_before)):
        for key in a:
            name = f'layer {i} {key}: change over the fit'
            assert b[key].dtype == np.float32
            got = b[key].astype(np.float64) - a0[key]
            want = np.asarray(a[key], np.float64) - a0[key]
            if _cancelled(pm, i, key):
                np.testing.assert_allclose(got, want, err_msg=name,
                                           **TOL_CANCELLED)
            elif jm32 is not None:
                if np.abs(got - want).max() > DELTA_ATOL:
                    want32 = np.asarray(jm32.params[i][key],
                                        np.float64) - a0[key]
                    bf16_close(name, *(torch.from_numpy(t)
                                       for t in (got, want, want32)))
            else:
                err = np.sqrt(np.mean((got - want) ** 2))
                size = np.sqrt(np.mean(want ** 2))
                assert err <= REL_CHANGE * size, (name, err, size)
    for a, b in zip(jm.state, state):
        if a:
            np.testing.assert_allclose(b['mean'], np.asarray(a['mean']),
                                       rtol=0, atol=2e-2)
            np.testing.assert_allclose(b['var'], np.asarray(a['var']),
                                       rtol=0, atol=5e-3)


@pytest.mark.parametrize('family,fused', [
    ('ensemble', 'force'), ('mve', 'force'), ('mc_dropout', 'force'),
    ('ensemble', False), ('mve', False)])
def test_bf16_mixed_fit_matches_jax(tmp_path, family, fused):
    cfg = {'precision': BF16, 'fused_epochs': fused}
    jm, jt, pm, pt = fit_both(tmp_path / 'bf16', family, cfg=cfg)
    jm32, jt32, _, _ = fit_both(tmp_path / 'fp32', family,
                                cfg={'fused_epochs': fused})
    kernel = fused == 'force'
    assert pt.fused_epochs_used == jt.fused_epochs_used == (3 if kernel
                                                            else 0)
    # the precision is recorded, set on the model, and the weights stay fp32
    assert pm.train_config['precision'] == jm.train_config['precision'] == BF16
    assert pm.precision == BF16 and pm.net.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in pm.net.parameters())
    got, want, want32 = (_losses(t) for t in (pt, jt, jt32))
    assert len(got) == len(want) == 18
    if kernel:
        n = CURVE_CHECKED
        bf16_close('train_loss', *(torch.from_numpy(a[:n])
                                   for a in (got, want, want32)))
        assert np.abs(got - want).max() <= np.abs(want - want32).max()
    else:
        np.testing.assert_allclose(got[:1], want[:1], **TIGHT)
        _within_gap(got, want, want32)
    if family != 'mc_dropout':
        _within_gap(*(_losses(t, 'val_loss') for t in (pt, jt, jt32)))
    _assert_changes_close(jm, pm, jm.params_before_fit,
                          jm32 if kernel else None)


@pytest.mark.parametrize('family', ['ensemble', 'ensemble_per_member',
                                    'mve'])
def test_per_step_gradients_round_as_jax(family):
    """One per-step gradient in bf16-mixed from the same weights and batch:
    autograd through the port's bf16 module walk rounds its cotangents
    where JAX's autodiff does. MC dropout draws each package's own masks
    and is not compared."""
    import jax
    import jax.numpy as jnp
    x, y = (a[:BS] for a in data())
    jm = jax_model(family)

    def jax_grad(precision):
        jm.set_precision(precision)
        return jax.grad(lambda p: jm.training_loss(
            p, jm.state, (jnp.asarray(x), jnp.asarray(y)),
            jax.random.PRNGKey(0))[0])(jm.params)
    want, want32 = jax_grad(BF16), jax_grad('32-true')
    pm = port_of(jm).set_precision(BF16)
    pm.net.train()
    loss = pm.training_loss((torch.from_numpy(x), torch.from_numpy(y)),
                            torch.Generator())
    grads = torch.autograd.grad(loss, list(pm.net.parameters()))
    with torch.no_grad():
        for p, g in zip(pm.net.parameters(), grads):
            p.copy_(g)
    got = to_pytrees(pm.net)[0]
    flat = ([], [], [])
    for i, trees in enumerate(zip(got, want, want32)):
        for key in trees[0]:
            if not _cancelled(pm, i, key):
                for f, t in zip(flat, trees):
                    f.append(torch.tensor(np.ravel(t[key]),
                                          dtype=torch.float32))
    res = bf16_close('gradient', *(torch.cat(f) for f in flat))
    assert res['gap_rms'] > 0


PRECISIONS = {
    # trainer precision: (kernel epochs, kernel form bf16, model precision)
    None: (1, False, None),
    '32-true': (1, False, '32-true'),
    'bf16-mixed': (1, True, 'bf16-mixed'),
    'bf16': (0, None, 'bf16'),
    'bf16-true': (0, None, 'bf16-true'),
    '32': (0, None, '32'),
}


@pytest.mark.parametrize('precision', list(PRECISIONS),
                         ids=[str(p) for p in PRECISIONS])
def test_precision_dispatch_follows_jax(tmp_path, monkeypatch, precision):
    """The JAX trainer's rules: the kernel for None, '32-true' and
    'bf16-mixed' (its bf16 form only for 'bf16-mixed'), the per-step path
    for 'bf16', 'bf16-true' and '32'; the precision recorded in
    ``train_config`` and set on the model."""
    kernel_epochs, form, model_precision = PRECISIONS[precision]
    forms = []
    epoch = pft.fused_epoch

    def spy(plan, *args, **kwargs):
        forms.append(plan.bf16)
        return epoch(plan, *args, **kwargs)
    monkeypatch.setattr(pft, 'fused_epoch', spy)
    x, y = data()
    cfg = {'accelerator': 'cpu', 'max_epochs': 1, 'fused_epochs': 'force',
           'whole_fit': False, 'precision': precision}
    jm = jax_model('ensemble')
    pm = port_of(jm)
    jt = jtr.Trainer('t', cfg, callbacks=[], log_dir=str(tmp_path),
                     version='jax')
    jt.fit(jm, jtr.DataLoader(jtr.ArrayDataset(x, y), BS, drop_last=True))
    pt = ptr.Trainer('t', cfg, callbacks=[], log_dir=str(tmp_path),
                     version='port', device='cpu')
    pt.fit(pm, ptr.DataLoader(ptr.ArrayDataset(x, y), BS, drop_last=True))
    assert pt.fused_epochs_used == jt.fused_epochs_used == kernel_epochs
    assert forms == ([form] if kernel_epochs else [])
    assert pm.precision == getattr(jm, 'precision', None) == model_precision
    assert pm.train_config.get('precision') == \
        jm.train_config.get('precision') == precision
    bf16 = precision in ('bf16-mixed', 'bf16', 'bf16-true')
    assert (pm.net.compute_dtype == torch.bfloat16) == bf16


def test_bf16_model_trains_the_kernel_in_fp32(tmp_path):
    """A model already in bf16 under a trainer precision of None: the
    kernel runs its fp32 form (the JAX rule keys the form on the trainer's
    precision), the model stays bf16 and validates in bf16, as in JAX."""
    x, y = data()
    jm = jax_model('ensemble')
    jm.set_precision(BF16)
    pm = port_of(jm).set_precision(BF16)
    cfg = {'accelerator': 'cpu', 'max_epochs': 2, 'fused_epochs': 'force',
           'whole_fit': False, 'log_every_n_steps': 1}
    loaders = []
    for pkg, m, version in ((jtr, jm, 'jax'), (ptr, pm, 'port')):
        tr = pkg.Trainer('t', cfg, callbacks=[], log_dir=str(tmp_path),
                         version=version,
                         **({'device': 'cpu'} if pkg is ptr else {}))
        dl = pkg.DataLoader(pkg.ArrayDataset(x, y), BS, drop_last=True)
        tr.fit(m, dl)
        loaders.append((tr, dl))
    (jt, _), (pt, pdl) = loaders
    assert pt.fused_epochs_used == jt.fused_epochs_used == 2
    assert pm.precision == BF16 and pm.net.compute_dtype == torch.bfloat16
    assert 'precision' not in pm.train_config or \
        pm.train_config['precision'] == jm.train_config.get('precision')
    # the kernel's fp32 form: the training losses agree to fp32 round-off
    np.testing.assert_allclose(_losses(pt), _losses(jt), **TIGHT)
    np.testing.assert_allclose(_losses(pt, 'val_loss'),
                               _losses(jt, 'val_loss'), **LOOSE)
    # and the logged validation is the bf16 one
    vl = pt.validate(pm, ptr.DataLoader(ptr.ArrayDataset(x, y), BS))
    assert abs(vl - _losses(pt, 'val_loss')[-1]) < 1e-6
    pm.set_precision('32-true')
    vl32 = pt.validate(pm, ptr.DataLoader(ptr.ArrayDataset(x, y), BS))
    assert abs(vl32 - vl) > 1e-6


def test_bf16_bundle_reloads_in_both_packages_and_serves_bf16(tmp_path):
    """The bundle of a bf16-mixed fit records the precision: it reloads in
    bf16 in both packages, serves through the bf16 fold (kernel 1b's plain
    version here), and reproduces its logged best validation loss."""
    from nnueehcs_tpu.training import load_model as jax_load_model
    x, y = data()
    pm = port_of(jax_model('ensemble'))
    saver = ptr.ModelSavingCallback()
    tr = ptr.Trainer('t', {'max_epochs': 3, 'fused_epochs': 'force',
                           'precision': BF16}, callbacks=[saver],
                     log_dir=str(tmp_path), device='cpu')
    tr.fit(pm, ptr.DataLoader(ptr.ArrayDataset(x, y), BS, drop_last=True),
           ptr.DataLoader(ptr.ArrayDataset(x, y), BS))
    path = os.path.join(tr.logger.log_dir, 'model.pth')
    best = ptr.load_model(path, device='cpu')
    assert best.precision == BF16 and best.train_config['precision'] == BF16
    assert best.net.compute_dtype == torch.bfloat16
    assert best.fused_weights().w_all.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in best.net.parameters())
    val = tr.validate(best, ptr.DataLoader(ptr.ArrayDataset(x, y), BS))
    assert abs(val - saver.best) < 1e-6
    mean, std = Predictor(best, device='cpu').predict(x)
    assert mean.dtype == std.dtype == np.float32
    assert np.isfinite(mean).all() and np.isfinite(std).all()
    jm = jax_load_model(path)
    assert str(jm.net.compute_dtype.__name__ if hasattr(
        jm.net.compute_dtype, '__name__') else jm.net.compute_dtype) \
        .endswith('bfloat16')
    assert jm.train_config['precision'] == BF16
