"""The port's seven UQ models served in bf16-mixed on the CPU, end to end
through ``Predictor``, against the JAX package on the same seeded weights
and rows; bundles that carry the precision both ways; and the banked
trial-21 Δ-UQ bundle, whose bf16 answer depends on the path.

The port's models on the CPU run their kernels' plain versions, where the
JAX models on the CPU run their module paths; in bf16 those are two
functions (the kernels fold BatchNorm into fp32 weights, then round; the
modules normalise in bf16). So each answer is held to the JAX function it
computes: the kernel's (Pallas interpret mode, ``tests/torch_bf16.py``'s
``assert_as_jax``: TOL_MEAN/TOL_STD, or past a bf16 rounding flip no
farther from a float64 chain than twice the JAX kernel) for the ensemble,
Δ-UQ and PAGER's spread, and the module path's (``assert_walk``) for PAGER's
score and the KDE, kNN-KDE and MVE MLP; the KDE and kNN-KDE densities stay
fp32 under every precision and are held to the fp32 bars. MC dropout is
held statistically, as in fp32: at S = 4096 its mean and std against the
JAX model's bf16 path (the module path, jax.random masks) within
STAT_FACTOR times that path's own seed-to-seed gap, plus, for the mean, the
measured p = 0 distance between the port's kernel function and the JAX
module path on the same rows (the two functions' clean passes differ in
bf16 by more than the sampling bar)."""
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnueehcs_tpu import model_builder as jmb
from nnueehcs_tpu.nn.layers import EVAL_MODE
from nnueehcs_tpu.ops import fused_anchored as jax_fa
from nnueehcs_tpu.ops import fused_ensemble as fe
from nnueehcs_tpu.training import load_model as jax_load_model
from nnueehcs_tpu.training import save_model as jax_save_model
from nnueehcs_tpu_torch import model_builder as pmb
from nnueehcs_tpu_torch import training as ptr
from nnueehcs_tpu_torch.ops import fused_anchored as fa
from nnueehcs_tpu_torch.ops.fused_ensemble import fused_forward_plain
from nnueehcs_tpu_torch.serving import Predictor
from nnueehcs_tpu_torch.training import load_model, save_model

from torch_bf16 import assert_as_jax, assert_walk, chain64
from torch_parity import (TOL_MEAN, TOL_STD, descr, jax_anchored,
                          jax_ensemble, jax_mc_dropout, port_of,
                          randomize_params, randomize_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRIAL_21 = os.path.join(REPO, 'experiments', 'full_cell', 'artifacts',
                        'binomial_options_delta_uq_tails', 'pareto_models',
                        'bo_trial_21', 'model.pth')
STAT_FACTOR = 3
TOL_KDE_SCORE = {'rtol': 1e-4, 'atol': 1e-30}   # as in fp32


@pytest.fixture
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))


def _x(rows, in_dim=5, seed=0):
    return np.random.default_rng(seed).normal(size=(rows, in_dim)).astype(
        np.float32)


def _serve(pm, x, **kw):
    """The port model served in bf16 through ``Predictor`` on the CPU;
    answers fp32."""
    pm.set_precision('bf16-mixed')
    out = Predictor(pm, device='cpu', buckets=(64, 256), **kw).predict(x)
    for o in (out if isinstance(out, tuple) else (out,)):
        assert o.dtype == np.float32
    return out


def _jax_kernel_1(jm, x):
    jm.set_precision('bf16-mixed')
    return fe.fused_ensemble_eval(jm.net, jm.params, jm.state, x,
                                  layout='xt', interpret=True)


def _jax_kernel_5(jm, x):
    jm.set_precision('bf16-mixed')
    cache = jax_fa.prepare_fused_anchored(jm.net, jm.params, jm.state)
    return jax_fa.fused_anchored_stats(cache, x, jm.anchors, jm.num_anchors)


def test_ensemble_serves_the_jax_kernel_function():
    jm = jax_ensemble(descr(in_dim=5, width=64, hidden=3), members=4, seed=1)
    pm = port_of(jm)
    x = _x(300, seed=1)
    got = _serve(pm, x)
    want = _jax_kernel_1(jm, x)
    ref64 = chain64(pm.fused_weights(), x)
    for g, w, r, tol, name in zip(got, want, ref64, (TOL_MEAN, TOL_STD),
                                  ('mean', 'std')):
        assert_as_jax(g, w, r, tol, name)


@pytest.mark.parametrize('kind,estimator', [('delta_uq', 'std'),
                                            ('delta_uq', 'var'),
                                            ('pager', 'std')])
def test_anchored_models_serve_the_jax_kernel_function(interpret_pallas, kind,
                                                       estimator):
    """Mean and spread: the anchored kernel's function (JAX kernel); PAGER's
    score: the bf16 module walk (JAX ``_conformal_scores``)."""
    jm = jax_anchored(descr(in_dim=5, width=32, hidden=2), kind=kind,
                      num_anchors=6, stored=8, estimator=estimator, seed=2)
    pm = port_of(jm)
    x = _x(300, seed=2)
    mean, ue = _serve(pm, x)
    kmean, kstd = (np.asarray(t) for t in _jax_kernel_5(jm, x))
    aw = pm.anchored_weights()
    r_mean, r_std = chain64(aw, x, fa.anchor_rows(aw, pm.anchors[:6]))
    assert_as_jax(mean, kmean, r_mean, TOL_MEAN, 'mean')
    spread = ue
    if kind == 'pager':
        scores = np.asarray(jm._conformal_scores(
            jm.params, jm.state, jnp.asarray(x), jnp.asarray(jm.anchors[:6]),
            jnp.asarray(jm.anchors_Y[:6])))
        with torch.no_grad():
            p = pm.prediction_matrix(torch.from_numpy(x), pm.anchors[:6])
        port_scores = (p - pm.anchors_Y[:6].reshape(1, -1)).abs().amax(
            1, keepdim=True)
        jm.set_precision('32-true')
        scores32 = np.asarray(jm._conformal_scores(
            jm.params, jm.state, jnp.asarray(x), jnp.asarray(jm.anchors[:6]),
            jnp.asarray(jm.anchors_Y[:6])))
        assert_walk(port_scores, scores, scores32, 'score')
        spread_port = fa.fused_anchored_stats(aw, torch.from_numpy(x),
                                              pm.anchors, 6)[1].numpy()
        np.testing.assert_array_equal(
            ue, np.maximum(spread_port, port_scores.numpy()))
        spread = spread_port
    if estimator == 'var':
        assert_as_jax(spread, kstd ** 2, r_std ** 2, TOL_STD, 'var')
    else:
        assert_as_jax(spread, kstd, r_std, TOL_STD, 'std')


def _jax_density(kind, uq):
    builder = {'kde': jmb.KDEModelBuilder, 'knn_kde': jmb.KNNKDEModelBuilder,
               'mve': jmb.MVEModelBuilder}[kind]
    m = builder(descr(in_dim=5, width=32, hidden=2,
                      out_dim=2 if kind == 'mve' else 1), uq, seed=3,
                train_config={'loss': 'l1_loss'}).build()
    m.params = randomize_params(m.params, 4)
    m.state = randomize_state(m.state, 5)
    m.invalidate_cache()
    if kind != 'mve':
        m.fit_kde(_x(400, seed=8))
    return m


@pytest.mark.parametrize('kind,uq', [('kde', {'rtol': 1000}),
                                     ('knn_kde', {'k': 7}),
                                     ('mve', {'min_variance': 1e-7})])
def test_density_models_serve_the_jax_module_function(kind, uq):
    """The prediction (and MVE's sigma) through the bf16 MLP, as JAX's; the
    KDE and kNN-KDE densities fp32, as in fp32."""
    jm = _jax_density(kind, uq)
    x = _x(300, seed=4) * 0.8
    want32 = [np.asarray(t) for t in jm(x, return_ue=True)]
    pm = port_of(jm)
    got = _serve(pm, x)
    jm.set_precision('bf16-mixed')
    want16 = [np.asarray(t) for t in jm(x, return_ue=True)]
    assert_walk(torch.from_numpy(got[0]), want16[0], want32[0], 'prediction')
    if kind == 'mve':
        assert_walk(torch.from_numpy(got[1]), want16[1], want32[1], 'sigma')
    else:
        np.testing.assert_allclose(got[1], want16[1], **TOL_KDE_SCORE)
        np.testing.assert_array_equal(want16[1], want32[1])


def test_mc_dropout_statistics_match_jax_within_sampling_noise():
    """S = 4096 on 64 rows, p = 0.2: the port's model (the kernel's
    function, hash masks) against the JAX model's bf16 path (modules,
    jax.random masks)."""
    S = 4096
    jm = jax_mc_dropout(descr(in_dim=5, width=32, hidden=3), num_samples=S,
                        p=0.2, seed=4)
    pm = port_of(jm)
    x = _x(64, seed=11)
    jm.set_precision('bf16-mixed')
    jm.reseed(1)
    a = [np.asarray(t) for t in jm(x, return_ue=True)]
    jm.reseed(2)
    b = [np.asarray(t) for t in jm(x, return_ue=True)]
    got = [t.numpy() for t in pm.set_precision('bf16-mixed')(
        x, return_ue=True)]
    # p = 0 distance of the two functions: the kernel's clean pass against
    # the JAX network's bf16 eval apply
    clean_port = fused_forward_plain(pm.mc_weights(), torch.from_numpy(x))[0]
    clean_jax, _ = jm.net.apply(jm.params, jm.state, jnp.asarray(x),
                                EVAL_MODE)
    d0 = float(np.abs(clean_port.numpy() - np.asarray(clean_jax)).max())
    for i, name in enumerate(('mean', 'std')):
        noise = float(np.abs(a[i] - b[i]).max())
        dev = float(np.abs(got[i] - a[i]).max())
        assert noise > 0
        bar = STAT_FACTOR * noise + (d0 if name == 'mean' else 0.0)
        assert dev <= bar, (name, dev, noise, d0)


@pytest.mark.parametrize('kind', ['ensemble', 'mc_dropout', 'delta_uq',
                                  'pager', 'kde', 'knn_kde', 'mve'])
def test_set_precision_refolds_and_fp32_comes_back_bit_for_bit(kind):
    """A switch to bf16-mixed rebuilds the folded weights (bf16) and changes
    the answers; a switch back to 32-true restores the fp32 answers bit
    for bit."""
    if kind == 'ensemble':
        jm = jax_ensemble(descr(in_dim=5, width=32, hidden=2), members=3)
    elif kind == 'mc_dropout':
        jm = jax_mc_dropout(descr(in_dim=5, width=32, hidden=2))
    elif kind in ('delta_uq', 'pager'):
        jm = jax_anchored(descr(in_dim=5, width=32, hidden=2), kind=kind,
                          num_anchors=5)
    else:
        jm = _jax_density(kind, {'mve': {}, 'kde': {'rtol': 1000},
                                 'knn_kde': {'k': 5}}[kind])
    pm = port_of(jm)
    x = _x(200, seed=6)
    if kind == 'mc_dropout':
        pm.reseed(0)
    first = [t.clone() for t in pm(x, return_ue=True)]
    folded = pm._folded
    pm.set_precision('bf16-mixed')
    if kind == 'mc_dropout':
        pm.reseed(0)
    bf16 = pm(x, return_ue=True)
    assert all(t.dtype == torch.float32 for t in bf16)
    assert not torch.equal(bf16[0], first[0])
    if folded is not None:
        assert pm._folded is not folded
        assert pm._folded.w_all.dtype == torch.bfloat16
    pm.set_precision('32-true')
    if kind == 'mc_dropout':
        pm.reseed(0)
    again = pm(x, return_ue=True)
    for a, f in zip(again, first):
        assert torch.equal(a, f)
    if folded is not None:
        assert pm._folded.w_all.dtype == torch.float32


def test_precisions_by_name():
    pm = port_of(jax_ensemble(descr(in_dim=5, width=16, hidden=1), members=2))
    for name in ('bf16', 'bf16-mixed', 'bf16-true'):
        assert pm.set_precision(name).net.compute_dtype == torch.bfloat16
    for name in (None, '32', '32-true', 32):
        assert pm.set_precision(name).net.compute_dtype is None
    for name in ('16-mixed', '16', 'fp16', 'bf17'):
        with pytest.raises(ValueError, match='precision'):
            pm.set_precision(name)


def test_jax_bf16_bundle_serves_in_bf16_and_port_bundle_carries_it_back(
        tmp_path):
    """A JAX bundle whose train_config names bf16-mixed loads into a bf16
    model; the port's bundle of it loads into a bf16 JAX model, and the
    two serve the same bf16 answers (JAX on the CPU: its module path)."""
    jm = jmb.EnsembleModelBuilder(
        descr(in_dim=5, width=32, hidden=2), {'num_models': 3}, seed=5,
        train_config={'loss': 'l1_loss', 'precision': 'bf16-mixed'}).build()
    assert jm.net.compute_dtype == jnp.bfloat16
    jpath = str(tmp_path / 'jax.pth')
    jax_save_model(jm, jpath)
    pm = load_model(jpath, device='cpu')
    assert pm.precision == 'bf16-mixed'
    assert pm.net.compute_dtype == torch.bfloat16
    assert pm.fused_weights().w_all.dtype == torch.bfloat16
    x = _x(200, seed=7)
    got = Predictor(pm, device='cpu', buckets=(256,)).predict(x)
    want = fe.fused_ensemble_eval(jm.net, jm.params, jm.state, x,
                                  layout='xt', interpret=True)
    ref64 = chain64(pm.fused_weights(), x)
    for g, w, r, tol in zip(got, want, ref64, (TOL_MEAN, TOL_STD)):
        assert_as_jax(g, w, r, tol, 'bundle')
    ppath = str(tmp_path / 'port.pth')
    save_model(pm, ppath)
    jm2 = jax_load_model(ppath)
    assert jm2.net.compute_dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jm2(x)), np.asarray(jm(x)))


def test_trainer_refuses_a_bf16_model(tmp_path):
    """(Named when the Trainer refused a bf16 model.) The Trainer now takes
    a model whose precision is bf16, a loaded bundle's or set, as the JAX
    trainer does: under a trainer precision of None it stays bf16, trains
    its per-step passes and validates in bf16, with fp32 master weights."""
    model = pmb.MLPModelBuilder(descr(in_dim=5, width=16, hidden=1),
                                device='cpu').build()
    model.set_precision('bf16-mixed')
    x = _x(64)
    dl = ptr.DataLoader(ptr.ArrayDataset(x, x[:, :1]), 16)
    tr = ptr.Trainer('t', {'max_epochs': 1}, callbacks=[],
                     log_dir=str(tmp_path), device='cpu')
    tr.fit(model, dl)
    assert tr.fused_epochs_used == 0
    assert model.precision == 'bf16-mixed'
    assert model.net.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.net.parameters())
    val = tr.validate(model, dl)
    assert np.isfinite(val) and abs(val - tr.callback_metrics['val_loss']) \
        < 1e-6


def _trial_21_rows(anchors, rows=256, seed=0):
    """Rows near the anchors the bundle was trained on: the anchors in
    turn, each with 0.05 N(0, 1) jitter."""
    rng = np.random.default_rng(seed)
    a = np.asarray(anchors)
    return (a[np.arange(rows) % a.shape[0]]
            + 0.05 * rng.normal(size=(rows, a.shape[1]))).astype(np.float32)


def test_trial_21_bundle_in_bf16_by_path(interpret_pallas, capsys):
    """The banked Δ-UQ bundle (5 anchors, 10 -> 128 x 6 -> 1 with
    BatchNorm) in bf16: the port's kernel path against the JAX anchored
    kernel's bf16 function, its module walk against the JAX module path
    (the path the banked bf16 rows came from); the two functions are far
    apart in bf16 (about 2.6 in the mean where |mean| reaches 349, 0.86 in
    the std where the median std is 0.13, on these rows), so the port's bf16
    Δ-UQ answers do not reproduce the banked bf16 rows."""
    jm, pm = jax_load_model(TRIAL_21), load_model(TRIAL_21, device='cpu')
    x = _trial_21_rows(jm.anchors)
    kernel16 = [np.asarray(t) for t in _jax_kernel_5(jm, x)]
    module16 = [np.asarray(t) for t in jm(x, return_ue=True)]
    jm.set_precision('32-true')
    module32 = [np.asarray(t) for t in jm(x, return_ue=True)]
    cache = jax_fa.prepare_fused_anchored(jm.net, jm.params, jm.state)
    kernel32 = [np.asarray(t) for t in jax_fa.fused_anchored_stats(
        cache, x, jm.anchors, jm.num_anchors)]
    pm.set_precision('bf16-mixed')
    got = pm(x, return_ue=True)
    aw = pm.anchored_weights()
    ref64 = chain64(aw, x, fa.anchor_rows(aw, pm.anchors[:pm.num_anchors]))
    for g, w, r, tol, name in zip(got, kernel16, ref64, (TOL_MEAN, TOL_STD),
                                  ('mean', 'std')):
        assert_as_jax(g, w, r, tol, f'kernel path {name}')
    with torch.no_grad():
        walk = pm.anchored_stats_modules(torch.from_numpy(x), pm.anchors,
                                         pm.num_anchors)
    for g, w16, w32, name in zip(walk, module16, module32, ('mean', 'std')):
        assert_walk(g, w16, w32, f'module walk {name}')
    apart = [float(np.abs(k - m).max()) for k, m in zip(kernel16, module16)]
    moved = [float(np.abs(k - m).max()) for k, m in zip(kernel16, kernel32)]
    with capsys.disabled():
        print(f'\ntrial 21 in bf16, {len(x)} rows: kernel vs module '
              f'mean {apart[0]:.3g}, std {apart[1]:.3g}; kernel bf16 vs fp32 '
              f'mean {moved[0]:.3g}, std {moved[1]:.3g}; |mean| up to '
              f'{float(np.abs(kernel16[0]).max()):.4g}, median std '
              f'{float(np.median(kernel16[1])):.3g}')
    assert 1.0 <= apart[0] <= 10.0 and 0.3 <= apart[1] <= 3.0, apart
    # in fp32 the two paths agree
    np.testing.assert_allclose(kernel32[0], module32[0], rtol=1e-5, atol=1e-3)
