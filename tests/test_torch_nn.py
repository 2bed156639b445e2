"""The port's layers, network builder and weight conversion against the JAX
package: the same numpy weights and inputs through ``Network.apply`` (eval
mode) and the port's modules. Tolerance: 1e-5 absolute and relative (f32
round-off through a few layers)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnueehcs_tpu.nn.layers import EVAL_MODE
from nnueehcs_tpu.nn.network import build_network as jax_build_network
from nnueehcs_tpu_torch import convert
from nnueehcs_tpu_torch.model_builder import EnsembleModelBuilder, MLPModelBuilder
from nnueehcs_tpu_torch.nn.network import LayerBuilder, build_network

from torch_parity import descr, randomize_params, randomize_state

TOL = {'rtol': 1e-5, 'atol': 1e-5}

ARCHS = {
    'bn_relu': descr(in_dim=5, width=32, hidden=2),
    'dropout': [{'Linear': {'args': [4, 16]}}, {'ReLU': {}},
                {'Dropout': {'args': [0.3]}}, {'Linear': {'args': [16, 2]}}],
    'no_bias': [{'Linear': {'args': [4, 16, False]}}, {'ReLU': {}},
                {'Linear': {'args': [16, 1], 'bias': False}}],
    'bn_no_affine': [{'Linear': {'args': [6, 8]}},
                     {'BatchNorm1d': {'args': [8], 'affine': False}},
                     {'ReLU': None}, {'Linear': {'args': [8, 3]}}],
}


def _jax_net(arch, seed=0):
    net = jax_build_network(arch)
    in_dim = arch[0]['Linear']['args'][0]
    params, state = net.init(jax.random.PRNGKey(seed), (1, in_dim))
    return net, randomize_params(params, seed + 1), randomize_state(state, seed + 2)


@pytest.mark.parametrize('name', sorted(ARCHS))
def test_network_forward_matches_jax(name):
    arch = ARCHS[name]
    net, params, state = _jax_net(arch)
    x = np.random.default_rng(3).normal(size=(64, arch[0]['Linear']['args'][0]))
    x = x.astype(np.float32)
    ref, _ = net.apply(params, state, jnp.asarray(x), EVAL_MODE)

    port = build_network(arch)
    convert.load_pytrees(port, jax.tree_util.tree_map(np.asarray, params),
                         jax.tree_util.tree_map(np.asarray, state))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_stacked_members_match_jax_member_by_member():
    arch = descr(in_dim=5, width=16, hidden=2)
    members = 3
    net = jax_build_network(arch)
    keys = jax.random.split(jax.random.PRNGKey(0), members)
    params, state = jax.vmap(lambda k: net.init(k, (1, 5)))(keys)
    params = randomize_params(params, 1)
    state = randomize_state(state, 2)
    x = np.random.default_rng(4).normal(size=(32, 5)).astype(np.float32)

    port = build_network(arch, members=members)
    convert.load_pytrees(port, jax.tree_util.tree_map(np.asarray, params),
                         jax.tree_util.tree_map(np.asarray, state))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (members, 32, 1)
    for i in range(members):
        p = jax.tree_util.tree_map(lambda a: a[i], params)
        s = jax.tree_util.tree_map(lambda a: a[i], state)
        ref, _ = net.apply(p, s, jnp.asarray(x), EVAL_MODE)
        np.testing.assert_allclose(got[i], np.asarray(ref), **TOL)


def test_convert_round_trip_is_exact():
    arch = ARCHS['bn_relu']
    net, params, state = _jax_net(arch)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    port = build_network(arch)
    convert.load_pytrees(port, params, state)
    back_params, back_state = convert.to_pytrees(port)
    for a, b in zip(jax.tree_util.tree_leaves((params, state)),
                    jax.tree_util.tree_leaves((back_params, back_state))):
        np.testing.assert_array_equal(a, b)
    # Linear weights go back to the JAX (in, out) layout
    assert back_params[0]['w'].shape == (5, 32)


def test_convert_rejects_wrong_shapes():
    port = build_network(ARCHS['bn_relu'])
    params, state = convert.to_pytrees(port)
    params = list(params)
    params[0] = {'w': np.zeros((32, 5), np.float32), 'b': params[0]['b']}
    with pytest.raises(ValueError, match='layer 0 w'):
        convert.load_pytrees(port, tuple(params), state)


def test_layer_builder_errors_name_the_layer():
    with pytest.raises(KeyError, match='Conv3d'):
        LayerBuilder()('Conv3d', 3, 4)
    with pytest.raises(TypeError) as err:
        LayerBuilder()('Linear', 3, 4, bogus=1)
    assert 'Linear' in err.value.args


def test_training_mode_is_not_ported():
    port = build_network(ARCHS['bn_relu'])
    port.train()
    with pytest.raises(NotImplementedError, match='evaluation'):
        port(torch.zeros(4, 5))


def test_builders_draw_from_a_seeded_generator():
    arch = descr(in_dim=5, width=16, hidden=1)
    a = EnsembleModelBuilder(arch, {'num_models': 4}, seed=7, device='cpu').build()
    b = EnsembleModelBuilder(arch, {'num_models': 4}, seed=7, device='cpu').build()
    c = EnsembleModelBuilder(arch, {'num_models': 4}, seed=8, device='cpu').build()
    wa, wb, wc = (m.net.layers[0].weight.detach() for m in (a, b, c))
    assert wa.shape == (4, 16, 5)
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    # members differ from each other; torch's default U(+-1/sqrt(fan_in))
    assert not torch.equal(wa[0], wa[1])
    assert float(wa.abs().max()) <= 1 / np.sqrt(5)
    mlp = MLPModelBuilder(arch, seed=7, device='cpu').build()
    assert mlp.net.layers[0].weight.shape == (16, 5)
    assert mlp(np.zeros((3, 5), np.float32)).shape == (3, 1)
