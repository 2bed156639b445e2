"""The port's KDE, kNN-KDE and MVE models on the CPU against the JAX
package: the same weights (carried through the bundle format both packages
read, with randomised BatchNorm state) and inputs give the same prediction
and UE; ``fit_kde`` keeps the same rows; bundles round-trip both ways with
every setting; the not-fitted error; ``Predictor``; ``gaussian_nll``; the
builders' info grabbers and rewrites; and the layers the density slice
added (the elementwise activations and ``LayerNorm``), including a Tanh
ensemble that the fold refuses and that runs through its modules.

Tolerances: prediction 1e-5 absolute and relative (tests/torch_parity.py
``TOL_MEAN``); the KDE and kNN scores ``-exp(log density)`` and
``-density`` 1e-4 relative, since the log density itself is held to 1e-4
absolute (tests/test_torch_kde.py, f32 round-off in the distance
decomposition); MVE sigma 1e-5 relative plus a tiny absolute; layers 1e-5
absolute and relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnueehcs_tpu import model_builder as jmb
from nnueehcs_tpu.models.mve import gaussian_nll as jax_gaussian_nll
from nnueehcs_tpu.nn.layers import EVAL_MODE
from nnueehcs_tpu.nn.network import build_network as jax_build_network
from nnueehcs_tpu.training import load_model as jax_load_model
from nnueehcs_tpu.training import save_model as jax_save_model
from nnueehcs_tpu_torch import convert
from nnueehcs_tpu_torch import model_builder as pmb
from nnueehcs_tpu_torch.models import KDEMLPModel, KNNKDEMLPModel
from nnueehcs_tpu_torch.models.mve import gaussian_nll
from nnueehcs_tpu_torch.nn.network import build_network
from nnueehcs_tpu_torch.ops.fused_ensemble import prepare_fused_weights
from nnueehcs_tpu_torch.serving import Predictor
from nnueehcs_tpu_torch.training import load_model, save_model

from torch_parity import (TOL_MEAN, descr, jax_ensemble, port_of,
                          randomize_params, randomize_state)

TOL_KDE_SCORE = {'rtol': 1e-4, 'atol': 1e-30}
TOL_UE = {'rtol': 1e-5, 'atol': 1e-12}
TOL_LAYER = {'rtol': 1e-5, 'atol': 1e-5}


def _x(rows, in_dim=5, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(rows, in_dim)) * scale
            ).astype(np.float32)


def _randomized(m, seed):
    m.params = randomize_params(m.params, seed + 1)
    m.state = randomize_state(m.state, seed + 2)
    m.invalidate_cache()
    return m


def jax_density(kind, layers=None, seed=0, fit_rows=400, **uq):
    """A seeded JAX KDE, kNN-KDE or MVE model with randomised BatchNorm
    state, fitted on numpy rows where it has a corpus."""
    layers = layers or descr(in_dim=5, width=32, hidden=2)
    builder = {'kde': jmb.KDEModelBuilder, 'knn_kde': jmb.KNNKDEModelBuilder,
               'mve': jmb.MVEModelBuilder}[kind]
    m = _randomized(builder(layers, uq, seed=seed,
                            train_config={'loss': 'l1_loss'}).build(), seed)
    if kind != 'mve':
        m.fit_kde(_x(fit_rows, layers[0]['Linear']['args'][0], seed=seed + 5))
    return m


MODELS = {
    'kde_scott': ('kde', {'rtol': 1000}),
    'kde_silverman_half': ('kde', {'bandwidth': 'silverman', 'rtol': 0.5,
                                   'train_fit_prop': 0.5}),
    'knn_k7': ('knn_kde', {'k': 7}),
    'knn_k_above_n': ('knn_kde', {'k': 1000, 'bandwidth': 0.4,
                                  'knn_exact': False}),
    'mve': ('mve', {'min_variance': 1e-7}),
    'mve_default': ('mve', {}),
}


def _assert_answers(kind, got, want):
    (pred, ue), (ref_pred, ref_ue) = got, (np.asarray(w) for w in want)
    pred, ue = np.asarray(pred), np.asarray(ue)
    np.testing.assert_allclose(pred, ref_pred, **TOL_MEAN)
    assert ue.shape == ref_ue.shape
    np.testing.assert_allclose(ue, ref_ue,
                               **(TOL_UE if kind == 'mve' else TOL_KDE_SCORE))


@pytest.mark.parametrize('name', sorted(MODELS))
def test_model_matches_jax(name):
    kind, uq = MODELS[name]
    jm = jax_density(kind, **uq)
    pm = port_of(jm)
    x = _x(300, seed=1, scale=0.8)
    got = pm(x, return_ue=True)
    want = jm(x, return_ue=True)
    _assert_answers(kind, got, want)
    shape = (300, 1) if kind == 'mve' else (300,)
    assert tuple(got[1].shape) == shape and tuple(got[0].shape) == (300, 1)
    assert float(torch.abs(got[1]).max()) > 0
    np.testing.assert_allclose(pm(x).numpy(), np.asarray(jm(x)), **TOL_MEAN)


@pytest.mark.parametrize('kind', ['kde', 'knn_kde'])
def test_fit_kde_keeps_the_jax_rows(kind):
    """``train_fit_prop`` < 1 takes the same ``default_rng(0)`` permutation
    rows in both packages."""
    jm = jax_density(kind, train_fit_prop=0.37)
    pm = port_of(jm)
    data = _x(400, seed=5)
    jm.fit_kde(data)
    pm.fit_kde(data)
    if kind == 'kde':
        got, want = pm.kde.data, jm.kde.data
        assert pm.kde.bandwidth_ == jm.kde.bandwidth_
    else:
        got, want = pm._fit_data, jm._fit_data
        assert pm._bandwidth_value == jm._bandwidth_value
    assert got.shape == (148, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


SETTINGS = {'kde': ('bandwidth', 'rtol', 'train_fit_prop'),
            'knn_kde': ('bandwidth', 'k', 'train_fit_prop', 'knn_exact'),
            'mve': ('min_variance',)}


@pytest.mark.parametrize('name', sorted(MODELS))
def test_bundles_round_trip_both_ways(name, tmp_path):
    kind, uq = MODELS[name]
    jm = jax_density(kind, **uq)
    jax_path, port_path = str(tmp_path / 'jax.pth'), str(tmp_path / 'port.pth')
    jax_save_model(jm, jax_path)
    pm = load_model(jax_path, device='cpu')
    save_model(pm, port_path)
    back = jax_load_model(port_path)
    for key in SETTINGS[kind]:
        assert pm.config_dict()[key] == jm.config_dict()[key], key
        assert back.config_dict()[key] == jm.config_dict()[key], key
    if kind == 'kde':
        assert pm.rtol == jm.rtol and pm.kde.rtol == jm.kde.rtol
    x = _x(50, seed=2)
    _assert_answers(kind, pm(x, return_ue=True), jm(x, return_ue=True))
    _assert_answers(kind, back(x, return_ue=True), jm(x, return_ue=True))


@pytest.mark.parametrize('kind', ['kde', 'knn_kde'])
def test_not_fitted_raises_only_for_the_ue(kind):
    builder = {'kde': pmb.KDEModelBuilder, 'knn_kde': pmb.KNNKDEModelBuilder}
    pm = builder[kind](descr(), {}, device='cpu').build()
    x = _x(10)
    assert pm(x).shape == (10, 1)
    with pytest.raises(ValueError, match='KDE not fitted yet'):
        pm(x, return_ue=True)
    with pytest.raises(ValueError, match='KDE not fitted yet'):
        pm.eval_output(torch.from_numpy(x), return_ue=True)
    path_model = port_of(jax_density(kind))
    assert path_model.arrays_dict()[
        'kde_data' if kind == 'kde' else 'knn_fit_data'].shape == (400, 5)
    assert pm.arrays_dict()['kde_data' if kind == 'kde'
                            else 'knn_fit_data'] is None


@pytest.mark.parametrize('kind', ['kde', 'knn_kde'])
def test_to_moves_the_corpus_with_the_net(kind):
    pm = port_of(jax_density(kind))
    pm.to('meta')
    corpus = pm.kde.data if kind == 'kde' else pm._fit_data
    assert corpus.device.type == 'meta' and pm.device.type == 'meta'


@pytest.mark.parametrize('name', ['kde_scott', 'knn_k7', 'mve'])
def test_predictor_serves_the_density_models(name):
    """1, 300 and 1,025 rows cross buckets; the KDE and kNN UE is (N,) and
    a single row gives a 0-d UE, as the model's own call does."""
    kind, uq = MODELS[name]
    jm = jax_density(kind, **uq)
    pred = Predictor(port_of(jm), device='cpu')
    assert pred.num_features == 5
    for rows in (1, 300, 1025):
        x = _x(rows, seed=rows)
        _assert_answers(kind, pred.predict(x), jm(x, return_ue=True))
    mean, ue = pred.predict(_x(1, seed=3)[0])
    assert mean.shape == (1,)
    assert ue.shape == ((1,) if kind == 'mve' else ())


def test_gaussian_nll_matches_jax():
    rng = np.random.default_rng(0)
    out = rng.normal(size=(64, 2)).astype(np.float32) * 3
    y = rng.normal(size=(64, 1)).astype(np.float32)
    got = gaussian_nll(torch.from_numpy(out), torch.from_numpy(y))
    want = jax_gaussian_nll(jnp.asarray(out), jnp.asarray(y))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


BUILDERS = {
    'ensemble': ('EnsembleModelBuilder', {'num_models': 3},
                 {'get_num_models': 3}),
    'mc_dropout': ('MCDropoutModelBuilder',
                   {'num_samples': 8, 'dropout_percent': 0.2},
                   {'get_num_samples': 8, 'get_dropout_percent': 0.2}),
    'delta_uq': ('DeltaUQMLPModelBuilder',
                 {'estimator': 'var', 'anchored_batch_size': 4},
                 {'get_estimator': 'var', 'get_batch_size': 4}),
    'pager': ('PAGERModelBuilder', {}, {'get_estimator': 'std'}),
    'mve': ('MVEModelBuilder', {'min_variance': 1e-7}, {}),
    'kde': ('KDEModelBuilder', {'rtol': 1000}, {}),
    'knn_kde': ('KNNKDEModelBuilder', {'k': 3}, {}),
}


@pytest.mark.parametrize('name', sorted(BUILDERS))
def test_builder_info_matches_jax(name):
    """``get_info`` before and after ``build``, and a second ``update_info``,
    rewrite the architecture once and install the same accessors as the
    JAX builders."""
    cls, uq, accessors = BUILDERS[name]
    layers = descr(in_dim=4, width=16, hidden=2, out_dim=2)
    jb = getattr(jmb, cls)(layers, dict(uq))
    pb = getattr(pmb, cls)(layers, dict(uq), device='cpu')
    for b in (jb, pb):
        b.get_info()
    jm, pm = jb.build(), pb.build()
    for b in (jb, pb):
        b.update_info(b.get_info())
    ji, pi = jb.get_info(), pb.get_info()
    assert (pi.is_mlp(), pi.is_cnn()) == (ji.is_mlp(), ji.is_cnn()) == \
        (True, False)
    assert pi.num_inputs() == ji.num_inputs()
    for key, value in accessors.items():
        assert getattr(pi, key)() == getattr(ji, key)() == value
    assert pb.model_descr[0] == jb.model_descr[0]
    assert pb.model_descr[-1] == jb.model_descr[-1]
    assert pm.net.layers[0].in_features == jm.net.layers[0].in_features
    assert pm.net.layers[-1].out_features == jm.net.layers[-1].out_features
    if name == 'mve':
        assert pm.net.layers[-1].out_features == 4
    if name in ('delta_uq', 'pager'):
        assert pm.net.layers[0].in_features == 8


def test_cnn_info_grabber_matches_jax():
    layers = [{'Conv2d': {'args': [3, 8, 3]}}, {'ReLU': {}},
              {'Flatten': {}}, {'Linear': {'args': [8, 1]}}]
    ji = jmb.ModelInfo.get_info_grabber(list(layers))
    pi = pmb.ModelInfo.get_info_grabber([dict(layer) for layer in layers])
    assert isinstance(pi, pmb.CNNInfoGrabber)
    assert (pi.is_cnn(), pi.is_mlp(), pi.num_inputs(), pi.num_layers()) == \
        (ji.is_cnn(), ji.is_mlp(), ji.num_inputs(), ji.num_layers())


LAYERS = {
    'tanh': [{'Tanh': {}}],
    'sigmoid': [{'Sigmoid': None}],
    'gelu_exact': [{'GELU': {}}],
    'gelu_tanh': [{'GELU': {'approximate': 'tanh'}}],
    'silu': [{'SiLU': {'inplace': True}}],
    'elu': [{'ELU': {'alpha': 0.7}}],
    'leaky_relu': [{'LeakyReLU': {'negative_slope': 0.2}}],
    'softplus': [{'Softplus': {'beta': 2.0, 'threshold': 3.0}}],
    'identity': [{'Identity': {}}],
    'layer_norm': [{'LayerNorm': {'args': [16], 'eps': 1e-3}}],
}


def _layer_arch(name):
    return [{'Linear': {'args': [4, 16]}}, *LAYERS[name],
            {'Linear': {'args': [16, 2]}}]


def _jax_net(arch, seed=0, members=None):
    net = jax_build_network(arch)
    keys = jax.random.split(jax.random.PRNGKey(seed), members or 1)
    params, state = [], []
    for key in keys:
        p, s = net.init(key, (1, 4))
        params.append(_randomize_norm(p, seed))
        state.append(s)
    if members is None:
        return net, params[0], state[0]
    stack = lambda *t: jnp.stack(t)
    return (net, jax.tree_util.tree_map(stack, *params),
            jax.tree_util.tree_map(stack, *state))


def _randomize_norm(params, seed):
    """LayerNorm scale/bias away from (1, 0) (randomize_params does it for
    BatchNorm, whose params have the same keys)."""
    return randomize_params(params, seed + 1)


@pytest.mark.parametrize('name', sorted(LAYERS))
def test_new_layers_match_jax(name):
    arch = _layer_arch(name)
    net, params, state = _jax_net(arch)
    x = _x(64, in_dim=4, seed=3, scale=3.0)
    want, _ = net.apply(params, state, jnp.asarray(x), EVAL_MODE)
    port = build_network(arch)
    convert.load_pytrees(port, jax.tree_util.tree_map(np.asarray, params),
                         jax.tree_util.tree_map(np.asarray, state))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_LAYER)
    back, _ = convert.to_pytrees(port)
    for got_p, want_p in zip(back, params):
        assert sorted(got_p) == sorted(want_p)


def test_layer_norm_ensemble_matches_jax_member_by_member():
    arch = _layer_arch('layer_norm')
    net, params, state = _jax_net(arch, members=3)
    x = _x(32, in_dim=4, seed=4)
    port = build_network(arch, members=3)
    convert.load_pytrees(port, jax.tree_util.tree_map(np.asarray, params),
                         jax.tree_util.tree_map(np.asarray, state))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for i in range(3):
        p = jax.tree_util.tree_map(lambda a: a[i], params)
        s = jax.tree_util.tree_map(lambda a: a[i], state)
        want, _ = net.apply(p, s, jnp.asarray(x), EVAL_MODE)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   **TOL_LAYER)


@pytest.mark.parametrize('act', [{'Tanh': {}}, {'LayerNorm': {'args': [16]}},
                                 {'GELU': {}}])
def test_non_relu_ensemble_does_not_fold_and_matches_jax(act):
    """The folds that gate kernels 1, 2 and 5 refuse a non-ReLU activation
    or a LayerNorm; such an ensemble runs through its modules and agrees
    with the JAX package."""
    layers = [{'Linear': {'args': [5, 16]}}, act, {'Linear': {'args': [16, 16]}},
              {'BatchNorm1d': {'args': [16]}}, {'ReLU': {}},
              {'Linear': {'args': [16, 1]}}]
    jm = jax_ensemble(layers, members=3)
    pm = port_of(jm)
    assert prepare_fused_weights(pm.net) is None
    assert pm.fused_weights() is None
    x = _x(100, seed=6)
    got = pm(x, return_ue=True)
    want = jm(x, return_ue=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL_MEAN)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-3, atol=1e-5)


def test_density_models_are_in_the_registry():
    from nnueehcs_tpu.models import MODEL_CLASSES as JAX_CLASSES
    from nnueehcs_tpu_torch.models import MODEL_CLASSES, model_class
    assert sorted(MODEL_CLASSES) == sorted(JAX_CLASSES)
    assert model_class('KDEMLPModel') is KDEMLPModel
    assert model_class('KNNKDEMLPModel') is KNNKDEMLPModel
