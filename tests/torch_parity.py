"""Shared set-up for the tests that hold the PyTorch port against the JAX
package: seeded JAX models with non-trivial BatchNorm state, their port
counterparts on the CPU, and the comparison tolerances."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnueehcs_tpu.model_builder import EnsembleModelBuilder
from nnueehcs_tpu_torch.training.checkpoint import FORMAT, build_from_bundle

# mean: f32 round-off through a few layers; std: the shifted one-pass
# variance against the two-pass reference (tests/test_fused_ensemble.py)
TOL_MEAN = {'rtol': 1e-5, 'atol': 1e-5}
TOL_STD = {'rtol': 1e-3, 'atol': 1e-5}


@pytest.fixture(scope='module')
def one_torch_thread():
    """torch on one intra-op thread for a module's tests: the suite runs
    several pytest-xdist workers on the same cores, and there the many
    small tensor ops of a BO loop or a GP fit spend their time waiting on
    the other workers' thread pools."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def descr(in_dim=5, width=32, hidden=2, out_dim=1, bn=True):
    layers = []
    fan_in = in_dim
    for _ in range(hidden):
        layers.append({'Linear': {'args': [fan_in, width]}})
        if bn:
            layers.append({'BatchNorm1d': {'args': [width]}})
        layers.append({'ReLU': {'inplace': True}})
        fan_in = width
    layers.append({'Linear': {'args': [fan_in, out_dim]}})
    return layers


def randomize_state(state, seed):
    """BatchNorm running statistics away from (0, 1), so folding does work."""
    rng = np.random.default_rng(seed)
    out = []
    for s in state:
        if s and 'mean' in s:
            s = {'mean': jnp.asarray(rng.normal(size=s['mean'].shape) * 0.3,
                                     jnp.float32),
                 'var': jnp.asarray(rng.uniform(0.5, 1.5, s['var'].shape),
                                    jnp.float32)}
        out.append(s)
    return tuple(out)


def randomize_params(params, seed):
    """BatchNorm affine parameters away from (1, 0)."""
    rng = np.random.default_rng(seed)
    out = []
    for p in params:
        if p and 'scale' in p:
            p = {'scale': jnp.asarray(rng.uniform(0.5, 1.5, p['scale'].shape),
                                      jnp.float32),
                 'bias': jnp.asarray(rng.normal(size=p['bias'].shape) * 0.1,
                                     jnp.float32)}
        out.append(p)
    return tuple(out)


def jax_ensemble(layers, members=3, seed=0):
    m = EnsembleModelBuilder(layers, {'num_models': members}, seed=seed,
                             train_config={'loss': 'l1_loss'}).build()
    m.params = randomize_params(m.params, seed + 1)
    m.state = randomize_state(m.state, seed + 2)
    m.invalidate_cache()
    return m


def port_of(jax_model):
    """The port's model on the CPU with the JAX model's weights, through the
    bundle format both packages read."""
    return build_from_bundle({'format': FORMAT,
                              'config': jax_model.config_dict(),
                              'arrays': jax_model.arrays_dict()},
                             device='cpu')


def member_outputs(jax_model, x):
    """(M, B, out) from the JAX network applied member by member."""
    from nnueehcs_tpu.nn.layers import EVAL_MODE
    outs = []
    for i in range(jax_model.num_models):
        p = jax.tree_util.tree_map(lambda a: a[i], jax_model.params)
        s = jax.tree_util.tree_map(lambda a: a[i], jax_model.state)
        o, _ = jax_model.net.apply(p, s, jnp.asarray(x), EVAL_MODE)
        outs.append(np.asarray(o))
    return np.stack(outs)


def assert_ue_close(got, want):
    """``got``/``want`` are (mean, std) pairs of arrays or tensors."""
    mean, std = (np.asarray(g) for g in got)
    ref_mean, ref_std = (np.asarray(w) for w in want)
    np.testing.assert_allclose(mean, ref_mean, **TOL_MEAN)
    np.testing.assert_allclose(std, ref_std, **TOL_STD)


def jax_mc_dropout(layers, num_samples=8, p=0.2, seed=0):
    """A seeded JAX MC-dropout model (Dropout before every hidden Linear)
    with non-trivial BatchNorm state."""
    from nnueehcs_tpu.model_builder import MCDropoutModelBuilder
    m = MCDropoutModelBuilder(layers, {'num_samples': num_samples,
                                       'dropout_percent': p}, seed=seed,
                              train_config={'loss': 'l1_loss'}).build()
    m.params = randomize_params(m.params, seed + 1)
    m.state = randomize_state(m.state, seed + 2)
    m.invalidate_cache()
    return m


def jax_anchored(layers, kind='delta_uq', num_anchors=7, stored=None,
                 estimator='std', seed=0, **descr_extra):
    """A seeded JAX Δ-UQ or PAGER model with ``stored`` anchors (default
    ``num_anchors``) drawn from numpy, and anchor targets for PAGER."""
    from nnueehcs_tpu.model_builder import (DeltaUQMLPModelBuilder,
                                            PAGERModelBuilder)
    builder = DeltaUQMLPModelBuilder if kind == 'delta_uq' else \
        PAGERModelBuilder
    m = builder(layers, {'estimator': estimator, 'num_anchors': num_anchors,
                         **descr_extra}, seed=seed,
                train_config={'loss': 'l1_loss'}).build()
    m.params = randomize_params(m.params, seed + 1)
    m.state = randomize_state(m.state, seed + 2)
    rng = np.random.default_rng(seed + 3)
    in_dim = layers[0]['Linear']['args'][0]
    m.anchors = rng.normal(size=(stored or num_anchors, in_dim)).astype(np.float32)
    if kind == 'pager':
        m.anchors_Y = rng.normal(size=(stored or num_anchors, 1)).astype(np.float32)
    m.invalidate_cache()
    return m
