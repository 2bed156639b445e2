"""The port's module walks in bf16-mixed against the JAX package's module
paths in bf16 on the CPU, on the same seeded weights and rows: ``Network``
(the ensemble's and MC dropout's unfoldable networks), ``mc_forward_modules``
(p = 0 exactly, p > 0 statistically), ``anchored_stats_modules`` (the JAX
Δ-UQ model's default path), ``prediction_matrix`` (PAGER's score) and the
KDE, kNN-KDE and MVE MLP; and each layer under a bf16 activation dtype.

Bars (``assert_walk``): the walks through Linear, BatchNorm1d, ReLU and
Dropout (every architecture the configs and committed bundles use) round at
the same places as JAX's, but a dot summed in another order can round its
bf16 output to the other neighbour (measured: 14 of 900 member outputs of
one case one unit apart, 4.9e-4; most cases agree exactly, and
``anchored_stats_modules`` within 6e-8, its anchor statistics combined in
another order). So each walk is held to JAX's by the root mean square of
the difference, at most a quarter of the root mean square of JAX's own
bf16-vs-fp32 gap on the same outputs, and by its largest element, at most
one bf16 unit at the outputs' largest magnitude. The other activations and
LayerNorm round differently in the two packages: XLA keeps fp32 across fused
elementwise ops and has its own bf16 approximations of erf, exp and
logistic, so GELU, Sigmoid, SiLU and Softplus differ from torch's in one
bf16 unit on about 10-40% of elements; each layer is therefore held to
JAX's within one bf16 unit (``TOL_UNIT``; LayerNorm, whose bf16
mean-subtract and rsqrt each round, within two) and to JAX's output dtype."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from nnueehcs_tpu import model_builder as jmb
from nnueehcs_tpu.nn.layers import EVAL_MODE
from nnueehcs_tpu_torch.ops import fused_mc_dropout as mc

from torch_bf16 import assert_walk
from torch_parity import (descr, jax_anchored, jax_ensemble, jax_mc_dropout,
                          member_outputs, port_of, randomize_params,
                          randomize_state)

# one bf16 unit at magnitude 1 (8 significant bits), relative and absolute
TOL_UNIT = {'rtol': 2.0 ** -7, 'atol': 2.0 ** -7}
STAT_FACTOR = 3


def _x(rows, in_dim=5, seed=0):
    return np.random.default_rng(seed).normal(size=(rows, in_dim)).astype(
        np.float32)


def _in_bf16(jm, fn):
    """``fn()`` with the JAX model in fp32, then in bf16-mixed."""
    jm.set_precision('32-true')
    a = fn()
    jm.set_precision('bf16-mixed')
    return a, fn()


@pytest.mark.parametrize('width,hidden,members', [(32, 2, 3), (64, 3, 2),
                                                  (128, 6, 2)])
def test_network_bf16_matches_jax(width, hidden, members):
    """The members' outputs through the modules (the ensemble's path for a
    network the kernel does not take)."""
    jm = jax_ensemble(descr(in_dim=5, width=width, hidden=hidden),
                      members=members, seed=width)
    x = _x(300, seed=width)
    want32, want16 = _in_bf16(jm, lambda: member_outputs(jm, x))
    pm = port_of(jm).set_precision('bf16-mixed')
    with torch.no_grad():
        got = pm.net(torch.from_numpy(x))
    assert_walk(got, want16, want32, 'members')
    # the ensemble model's module path (a Dropout keeps the kernel off)
    std, mean = torch.std_mean(got, dim=0, correction=1)
    assert_walk(mean, want16.mean(0), want32.mean(0), 'mean')
    assert_walk(std, want16.std(0, ddof=1), want32.std(0, ddof=1), 'std')


def test_mc_forward_modules_p0_is_jax_clean_pass():
    """p = 0: every sample is the clean pass, the JAX network's bf16 apply
    in eval mode."""
    jm = jax_mc_dropout(descr(in_dim=5, width=32, hidden=2), p=0.0, seed=2)
    x = _x(300, seed=2)

    def clean():
        out, _ = jm.net.apply(jm.params, jm.state, jnp.asarray(x), EVAL_MODE)
        return np.asarray(out)
    want32, want16 = _in_bf16(jm, clean)
    pm = port_of(jm).set_precision('bf16-mixed')
    with torch.no_grad():
        mean, std = mc.mc_forward_modules(pm.net, torch.from_numpy(x), 5, 7)
    assert_walk(mean, want16, want32, 'clean pass')
    assert float(std.abs().max()) == 0.0


def test_mc_forward_modules_statistics_match_jax_within_sampling_noise():
    """p = 0.2, S = 4096 on 64 rows: the port's module walk (hash masks)
    against the JAX model's bf16 module path (jax.random masks), within
    STAT_FACTOR times the JAX path's own deviation between two seeds."""
    S = 4096
    jm = jax_mc_dropout(descr(in_dim=5, width=32, hidden=3), num_samples=S,
                        p=0.2, seed=4)
    jm.set_precision('bf16-mixed')
    x = _x(64, seed=11)
    jm.reseed(1)
    a = [np.asarray(t) for t in jm(x, return_ue=True)]
    jm.reseed(2)
    b = [np.asarray(t) for t in jm(x, return_ue=True)]
    pm = port_of(jm).set_precision('bf16-mixed')
    with torch.no_grad():
        got = mc.mc_forward_modules(pm.net, torch.from_numpy(x), S, 12345)
    for i, name in enumerate(('mean', 'std')):
        noise = float(np.abs(a[i] - b[i]).max())
        dev = float(np.abs(got[i].numpy() - a[i]).max())
        assert noise > 0
        assert dev <= STAT_FACTOR * noise, (name, dev, noise)


@pytest.mark.parametrize('estimator,n_anchors,stored,budget', [
    ('std', 7, 7, None), ('var', 7, 7, None), ('std', 4, 9, None),
    ('var', 6, 9, 600)])
def test_anchored_stats_modules_bf16_matches_jax(estimator, n_anchors, stored,
                                                 budget):
    """The Δ-UQ anchored walk against the JAX model's default (module)
    path; a rows budget of 600 makes both combine anchor groups."""
    extra = {} if budget is None else {'anchored_batch_size': 1}
    jm = jax_anchored(descr(in_dim=5, width=32, hidden=2),
                      num_anchors=n_anchors, stored=stored,
                      estimator=estimator, **extra)
    x = _x(300, seed=5)
    if budget is not None:
        jm.MIN_ROWS_BUDGET = budget
    want32, want16 = _in_bf16(jm, lambda: [np.asarray(t) for t in
                                           jm(x, return_ue=True)])
    pm = port_of(jm).set_precision('bf16-mixed')
    if budget is not None:
        pm.MIN_ROWS_BUDGET = budget
        assert pm._rows_budget() == budget
    with torch.no_grad():
        got = pm.anchored_stats_modules(torch.from_numpy(x), pm.anchors,
                                        n_anchors)
    for g, w16, w32, name in zip(got, want16, want32, ('mean', 'spread')):
        assert_walk(g, w16, w32, name)


def test_prediction_matrix_bf16_matches_jax():
    jm = jax_anchored(descr(in_dim=5, width=32, hidden=2), kind='pager',
                      num_anchors=7)
    x = _x(300, seed=6)
    want32, want16 = _in_bf16(jm, lambda: np.asarray(jm._prediction_matrix(
        jm.params, jm.state, jnp.asarray(x), jnp.asarray(jm.anchors))))
    pm = port_of(jm).set_precision('bf16-mixed')
    with torch.no_grad():
        got = pm.prediction_matrix(torch.from_numpy(x), pm.anchors)
    assert_walk(got, want16, want32, 'prediction matrix')


def _jax_density(kind, uq):
    builder = {'kde': jmb.KDEModelBuilder, 'knn_kde': jmb.KNNKDEModelBuilder,
               'mve': jmb.MVEModelBuilder}[kind]
    m = builder(descr(in_dim=5, width=32, hidden=2, out_dim=2), uq, seed=3,
                train_config={'loss': 'l1_loss'}).build()
    m.params = randomize_params(m.params, 4)
    m.state = randomize_state(m.state, 5)
    m.invalidate_cache()
    return m


@pytest.mark.parametrize('kind,uq', [('kde', {'rtol': 1000}),
                                     ('knn_kde', {'k': 5}),
                                     ('mve', {'min_variance': 1e-7})])
def test_density_mlp_bf16_matches_jax(kind, uq):
    """The KDE, kNN-KDE and MVE prediction (and MVE's sigma) through the
    bf16 MLP; the densities stay fp32 (tests/test_torch_bf16_models.py)."""
    jm = _jax_density(kind, uq)
    x = _x(300, seed=7)
    if kind == 'mve':
        want32, want16 = _in_bf16(jm, lambda: [np.asarray(t) for t in
                                               jm(x, return_ue=True)])
        got = port_of(jm).set_precision('bf16-mixed')(x, return_ue=True)
    else:
        want32, want16 = _in_bf16(jm, lambda: [np.asarray(jm(x))])
        got = [port_of(jm).set_precision('bf16-mixed')(x)]
    for g, w16, w32 in zip(got, want16, want32):
        assert_walk(g, w16, w32, kind)


LAYERS = [
    ('Linear', (32, 24), {}), ('BatchNorm1d', (32,), {}), ('ReLU', (), {}),
    ('Dropout', (0.3,), {}), ('Tanh', (), {}), ('Sigmoid', (), {}),
    ('GELU', (), {}), ('GELU', (), {'approximate': 'tanh'}), ('SiLU', (), {}),
    ('ELU', (), {'alpha': 0.7}), ('LeakyReLU', (), {'negative_slope': 0.1}),
    ('Softplus', (), {'beta': 2.0, 'threshold': 5.0}), ('Identity', (), {}),
    ('LayerNorm', (32,), {})]


@pytest.mark.parametrize('name,args,kwargs', LAYERS,
                         ids=[f'{n}{i}' for i, (n, _, _) in enumerate(LAYERS)])
def test_layer_under_bf16_matches_jax(name, args, kwargs):
    """Each layer on a bf16 input, eval mode: the JAX layer's output dtype
    (bf16, or fp32 where LayerNorm's fp32 parameters promote it), values
    within one bf16 unit of JAX's (two for LayerNorm)."""
    from nnueehcs_tpu_torch import convert
    from nnueehcs_tpu_torch.nn.network import build_network
    from nnueehcs_tpu.nn.network import build_network as jax_build_network
    import jax
    arch = [{name: {'args': list(args), **kwargs}}]
    jnet = jax_build_network(arch)
    params, state = jnet.init(jax.random.PRNGKey(0), (32,))
    params = randomize_params(params, 1)
    state = randomize_state(state, 2)
    pnet = build_network(arch)
    convert.load_pytrees(pnet, jax.tree_util.tree_map(np.asarray, params),
                         jax.tree_util.tree_map(np.asarray, state))
    x = (_x(200, in_dim=32, seed=9) * 2.0 + 0.3)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want, _ = jnet.layers[0].apply(params[0], state[0], xb, EVAL_MODE)
    with torch.no_grad():
        got = pnet.layers[0](torch.from_numpy(np.asarray(
            xb.astype(jnp.float32))).bfloat16())
    assert str(got.dtype).split('.')[-1] == str(want.dtype)
    units = 2 if name == 'LayerNorm' else 1
    tol = {k: units * v for k, v in TOL_UNIT.items()}
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


def test_batchnorm_train_mode_under_bf16_matches_jax():
    """Training-mode BatchNorm1d on a bf16 input, as the per-step path runs
    it in bf16-mixed: the batch mean and (biased) variance and the EMA
    (unbiased) in fp32 from the up-cast input, the normalise and affine in
    bf16. A mean-50 column is where statistics taken in bf16 would show
    (one bf16 unit at 50 is 0.25). Output within one bf16 unit of JAX's;
    running statistics within 1e-6 (fp32 round-off)."""
    import jax
    from nnueehcs_tpu.nn.layers import TRAIN_MODE
    from nnueehcs_tpu.nn.network import build_network as jax_build_network
    from nnueehcs_tpu_torch import convert
    from nnueehcs_tpu_torch.nn.network import build_network
    arch = [{'BatchNorm1d': {'args': [128]}}]
    jnet = jax_build_network(arch)
    params, state = jnet.init(jax.random.PRNGKey(0), (128,))
    params = randomize_params(params, 1)
    state = randomize_state(state, 2)
    pnet = build_network(arch)
    convert.load_pytrees(pnet, jax.tree_util.tree_map(np.asarray, params),
                         jax.tree_util.tree_map(np.asarray, state))
    x = np.random.default_rng(3).normal(50.0, 3.0, (128, 128))
    xb = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    want, new_state = jnet.layers[0].apply(params[0], state[0], xb,
                                           TRAIN_MODE)
    layer = pnet.layers[0].train()
    with torch.no_grad():
        got = layer(torch.from_numpy(np.asarray(
            xb.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16 and str(want.dtype) == 'bfloat16'
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL_UNIT)
    np.testing.assert_allclose(layer.running_mean.numpy(),
                               np.asarray(new_state['mean']), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(layer.running_var.numpy(),
                               np.asarray(new_state['var']), rtol=0,
                               atol=1e-6)
