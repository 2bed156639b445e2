"""The port's CNN layers (``Conv2d``, ``BatchNorm2d``, ``Flatten``,
``MaxPool2d``, ``AvgPool2d``) and ``register_layer`` against the JAX
package's: the same numpy weights and NCHW inputs, made from a seed,
through the JAX layer's ``apply`` (``jax.vmap`` over M = 3 stacked
members) and the port's module. Tolerances: fp32 1e-5 absolute and
relative; bf16 one bf16 unit of the JAX output (both accumulate bf16
products in fp32, in other orders, then round)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnueehcs_tpu.nn import layers as jl
from nnueehcs_tpu.nn.network import build_network as jax_build_network
from nnueehcs_tpu_torch import convert
from nnueehcs_tpu_torch.nn import layers as pl
from nnueehcs_tpu_torch.nn.network import LayerBuilder, build_network
from torch_parity import one_torch_thread  # noqa: F401

# torch on one intra-op thread: the suite's xdist workers share the cores
pytestmark = pytest.mark.usefixtures('one_torch_thread')

TOL = {'rtol': 1e-5, 'atol': 1e-5}
MEMBERS = 3
BF16 = torch.bfloat16


def bf16_unit(v):
    """One bf16 unit (8 significant bits) at each value of ``v``."""
    mag = np.maximum(np.abs(np.asarray(v, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def assert_close(got, want, bf16=False):
    got = np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    if bf16:
        # an infinity (a max pool's window wholly in the padding) must be
        # the same infinity; every finite value within a bf16 unit
        inf = np.isinf(want)
        np.testing.assert_array_equal(got[inf], want[inf])
        assert np.all(np.abs(got[~inf] - want[~inf])
                      <= bf16_unit(want[~inf]))
    else:
        np.testing.assert_allclose(got, want, **TOL)


def images(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def jax_apply(layer, params, state, x, mode, members):
    """The JAX layer on ``x``; with ``members`` its params and state are
    stacked and a 5-D ``x`` carries one batch per member."""
    def one(p, s, xi):
        return layer.apply(p, s, xi, mode)
    if members is None:
        return one(params, state, jnp.asarray(x))
    x_axis = 0 if x.ndim == 5 else None
    return jax.vmap(one, in_axes=(0, 0, x_axis))(params, state,
                                                   jnp.asarray(x))


def jax_init(layer, in_shape, members, seed=0):
    def one(k):
        p, s, _ = layer.init(k, in_shape)
        return p, s
    if members is None:
        return one(jax.random.PRNGKey(seed))
    return jax.vmap(one)(jax.random.split(jax.random.PRNGKey(seed), members))


def port_input(x, bf16):
    t = torch.from_numpy(x)
    return t.to(BF16) if bf16 else t


def jax_input(x, bf16):
    return jnp.asarray(x, jnp.bfloat16) if bf16 else jnp.asarray(x)


@pytest.mark.parametrize('bf16', [False, True], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('members,stacked', [(None, False), (MEMBERS, False),
                                             (MEMBERS, True)],
                         ids=['single', 'members', 'members_stacked_input'])
@pytest.mark.parametrize('stride,padding,bias', [(1, 0, True), (1, 1, True),
                                                 (2, 1, False), (2, 0, True)])
def test_conv2d_matches_jax(stride, padding, bias, members, stacked, bf16):
    layer = jl.Conv2d(3, 5, 3, stride=stride, padding=padding, bias=bias)
    params, state = jax_init(layer, (1, 3, 9, 9), members)
    shape = ((MEMBERS,) if stacked else ()) + (4, 3, 9, 9)
    x = images(1, shape)
    want, _ = jax_apply(layer, params, state, jax_input(x, bf16),
                        jl.EVAL_MODE, members)

    port = pl.Conv2d(3, 5, 3, stride=stride, padding=padding, bias=bias,
                     members=members)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.asarray(params['w'])))
        if bias:
            port.bias.copy_(torch.from_numpy(np.asarray(params['b'])))
        got = port(port_input(x, bf16))
    assert got.dtype == (BF16 if bf16 else torch.float32)
    if members is not None:
        assert got.shape[:2] == (MEMBERS, 4)
    assert_close(got.float().numpy(), want, bf16)


def test_conv2d_init_bound_and_layout():
    port = pl.Conv2d(3, 5, 3, members=MEMBERS)
    port.reset_parameters(torch.Generator().manual_seed(0))
    bound = 1.0 / np.sqrt(3 * 9)
    assert tuple(port.weight.shape) == (MEMBERS, 5, 3, 3, 3)
    for p in (port.weight, port.bias):
        assert float(p.abs().max()) <= bound and float(p.abs().max()) > bound / 2
    # the JAX init's shapes: OIHW, no transpose across
    params, _ = jax_init(jl.Conv2d(3, 5, 3), (1, 3, 9, 9), MEMBERS)
    assert params['w'].shape == tuple(port.weight.shape)


def _bn_state(members, seed=5):
    rng = np.random.default_rng(seed)
    lead = () if members is None else (members,)
    params = {'scale': jnp.asarray(rng.uniform(0.5, 1.5, lead + (4,)), jnp.float32),
              'bias': jnp.asarray(rng.normal(size=lead + (4,)) * 0.1, jnp.float32)}
    state = {'mean': jnp.asarray(rng.normal(size=lead + (4,)) * 0.3, jnp.float32),
             'var': jnp.asarray(rng.uniform(0.5, 1.5, lead + (4,)), jnp.float32)}
    return params, state


@pytest.mark.parametrize('bf16', [False, True], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('members', [None, MEMBERS], ids=['single', 'members'])
@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_batchnorm2d_matches_jax(train, members, bf16):
    layer = jl.BatchNorm2d(4)
    params, state = _bn_state(members)
    shape = ((MEMBERS,) if members else ()) + (6, 4, 5, 5)
    x = images(2, shape) * 2.0 + 0.7
    mode = jl.TRAIN_MODE if train else jl.EVAL_MODE
    want, new_state = jax_apply(layer, params, state, jax_input(x, bf16),
                                mode, members)

    port = pl.BatchNorm2d(4, members=members)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.asarray(params['scale'])))
        port.bias.copy_(torch.from_numpy(np.asarray(params['bias'])))
        port.running_mean.copy_(torch.from_numpy(np.asarray(state['mean'])))
        port.running_var.copy_(torch.from_numpy(np.asarray(state['var'])))
    port.train(train)
    with torch.no_grad():
        got = port(port_input(x, bf16))
    assert got.dtype == (BF16 if bf16 else torch.float32)
    assert_close(got.float().numpy(), want, bf16)
    # the EMA of the batch statistics (fp32 in both, from the input as given)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(new_state['mean']), **TOL)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(new_state['var']), **TOL)


def test_batchnorm2d_reduces_over_batch_and_image_not_members():
    """Training statistics per member and channel over (B, H, W), with the
    unbiased variance (n = B H W) in the EMA."""
    port = pl.BatchNorm2d(2, momentum=1.0, members=2)
    x = torch.from_numpy(images(3, (2, 4, 2, 3, 3)))
    x[1] = x[1] * 3 + 5
    port.train()
    with torch.no_grad():
        port(x)
    xd = x.double()
    want_mean = xd.mean(dim=(1, 3, 4))
    want_var = xd.var(dim=(1, 3, 4), correction=1)
    np.testing.assert_allclose(port.running_mean.numpy(), want_mean.numpy(),
                               **TOL)
    np.testing.assert_allclose(port.running_var.numpy(), want_var.numpy(),
                               **TOL)


@pytest.mark.parametrize('start,end', [(1, -1), (2, -1), (1, 2), (0, 1)])
def test_flatten_matches_jax(start, end):
    x = images(4, (3, 4, 5, 6))
    want, _ = jl.Flatten(start, end).apply({}, {}, jnp.asarray(x),
                                           jl.EVAL_MODE)
    got = pl.Flatten(start, end)(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_flatten_keeps_the_member_axis():
    """``start_dim`` counts from the batch axis: on an activation with a
    member axis in front the flatten starts one place on, as JAX's vmap
    sees one member at a time."""
    x = images(5, (MEMBERS, 2, 4, 3, 3))
    want = jax.vmap(lambda xi: jl.Flatten().apply({}, {}, xi,
                                                  jl.EVAL_MODE)[0])(jnp.asarray(x))
    got = pl.Flatten()(torch.from_numpy(x), stacked=True)
    assert tuple(got.shape) == (MEMBERS, 2, 36)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# the last cases pad wider than half the window, which torch's own pools
# refuse: windows wholly in the padding give -inf (max) or 0 (mean)
POOLS = [('MaxPool2d', 2, None, 0), ('MaxPool2d', 3, 2, 1),
         ('MaxPool2d', 2, 1, 1), ('AvgPool2d', 2, None, 0),
         ('AvgPool2d', 3, 2, 1), ('AvgPool2d', 2, 1, 1),
         ('MaxPool2d', 2, 2, 2), ('MaxPool2d', 1, 1, 1),
         ('MaxPool2d', 3, 1, 2), ('AvgPool2d', 1, 1, 1),
         ('AvgPool2d', 3, 1, 2), ('AvgPool2d', 2, 2, 2)]


@pytest.mark.parametrize('bf16', [False, True], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('stacked', [False, True], ids=['nchw', 'members'])
@pytest.mark.parametrize('name,k,stride,padding', POOLS,
                         ids=[f'{p[0]}_k{p[1]}_s{p[2]}_p{p[3]}' for p in POOLS])
def test_pools_match_jax(name, k, stride, padding, stacked, bf16):
    layer = getattr(jl, name)(k, stride, padding)
    x = images(6, ((MEMBERS,) if stacked else ()) + (2, 3, 7, 7))
    if stacked:
        want = jax.vmap(lambda xi: layer.apply({}, {}, xi, jl.EVAL_MODE)[0])(
            jax_input(x, bf16))
    else:
        want, _ = layer.apply({}, {}, jax_input(x, bf16), jl.EVAL_MODE)
    got = getattr(pl, name)(k, stride, padding)(port_input(x, bf16))
    assert got.dtype == (BF16 if bf16 else torch.float32)
    if name == 'AvgPool2d' and bf16:
        # XLA sums the window in bf16, each add rounding, in an order of
        # its own: k^2 - 1 partial sums, each off by at most half a bf16
        # unit of the window's sum of magnitudes S. The port sums in fp32
        # and rounds the mean once, at most half a unit of S / k^2. So the
        # two part by at most (k^2 - 1) units of S, then divided by k^2
        mags = port_input(x, bf16).double().abs().reshape(
            (-1,) + x.shape[-3:])
        sums = torch.nn.functional.avg_pool2d(
            torch.nn.functional.pad(mags, (padding,) * 4), k, stride or k,
            divisor_override=1).reshape(got.shape).numpy()
        err = np.abs(got.float().numpy()
                     - np.asarray(jnp.asarray(want, jnp.float32)))
        assert np.all(err <= (k * k - 1) * bf16_unit(sums) / (k * k))
    else:
        assert_close(got.float().numpy(), want, bf16)


CNN = [{'Conv2d': {'args': [2, 4, 3], 'padding': 1}},
       {'BatchNorm2d': {'args': [4]}}, {'ReLU': {}},
       {'Conv2d': {'args': [4, 6, 3], 'stride': 2, 'padding': 1}},
       {'BatchNorm2d': {'args': [6]}}, {'ReLU': {}},
       {'AvgPool2d': {'args': [2], 'padding': 1}},
       {'MaxPool2d': {'args': [2, 1]}},
       {'Flatten': {}}, {'Linear': {'args': [24, 8]}},
       {'BatchNorm1d': {'args': [8]}}, {'ReLU': {}},
       {'Linear': {'args': [8, 2]}}]


def _jax_cnn(members, seed=0):
    net = jax_build_network(CNN)

    def one(k):
        return net.init(k, (1, 2, 8, 8))
    if members is None:
        params, state = one(jax.random.PRNGKey(seed))
    else:
        params, state = jax.vmap(one)(
            jax.random.split(jax.random.PRNGKey(seed), members))
    rng = np.random.default_rng(seed + 1)
    state = tuple(
        {'mean': rng.normal(size=s['mean'].shape).astype(np.float32) * 0.3,
         'var': rng.uniform(0.5, 1.5, s['var'].shape).astype(np.float32)}
        if s else s for s in state)
    return net, jax.tree_util.tree_map(np.asarray, params), state


@pytest.mark.parametrize('bf16', [False, True], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('members', [None, MEMBERS], ids=['single', 'members'])
def test_cnn_network_matches_jax(members, bf16):
    net, params, state = _jax_cnn(members)
    x = images(7, (5, 2, 8, 8))

    def run(compute_dtype):
        net.compute_dtype = compute_dtype

        def apply(p, s):
            return net.apply(p, s, jnp.asarray(x), jl.EVAL_MODE)[0]
        return apply(params, state) if members is None else \
            jax.vmap(apply)(params, state)
    want = run(jnp.bfloat16 if bf16 else None)

    port = build_network(CNN, members=members)
    convert.load_pytrees(port, params, state)
    port.compute_dtype = BF16 if bf16 else None
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    if bf16:
        # bf16 roundings compound through the layers: as the MLP walk
        # (tests/test_torch_bf16_modules.py), held to the bf16-vs-fp32 gap
        gap = np.abs(np.asarray(want, np.float32) - np.asarray(run(None)))
        err = np.abs(got.numpy() - np.asarray(want, np.float32))
        assert err.max() <= gap.max()
    else:
        assert_close(got.numpy(), want)
    back_params, back_state = convert.to_pytrees(port)
    for a, b in zip(jax.tree_util.tree_leaves((params, state)),
                    jax.tree_util.tree_leaves((back_params, back_state))):
        np.testing.assert_array_equal(a, b)


def test_register_layer_extends_the_builder():
    class Double(torch.nn.Module):
        def __init__(self, members=None):
            super().__init__()

        def forward(self, x):
            return 2 * x

    with pytest.raises(KeyError, match='Double'):
        LayerBuilder()('Double')
    pl.register_layer('Double', Double)
    try:
        assert pl.LAYER_REGISTRY['Double'] is Double
        net = build_network([{'Conv2d': {'args': [1, 2, 1], 'bias': False}},
                             {'Double': None}, {'Flatten': {}}])
        with torch.no_grad():
            net.layers[0].weight.fill_(1.0)
            got = net(torch.ones(1, 1, 2, 2))
        np.testing.assert_array_equal(got.numpy(), np.full((1, 8), 2.0))
    finally:
        del pl.LAYER_REGISTRY['Double']
