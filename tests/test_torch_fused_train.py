"""The port's training-kernel plan, flat buffers and plain epoch
(``nnueehcs_tpu_torch/ops/fused_train.py``) against the JAX package's
(``nnueehcs_tpu/ops/fused_train.py``, the Pallas kernel run in interpret
mode on the CPU, as the JAX package's own tests run it).

Every epoch starts both packages from the same buffers: JAX-packed theta
and sigma of a model with non-trivial BatchNorm state, and non-zero Adam
moments (from zero moments, Adam divides by the square root of a
rounding-level second moment along directions with no signal, the
BatchNorm-cancelled Linear biases, and moves them by up to lr per step on
the sign of a rounding error: that is why tests/test_fused_train.py holds
parameters to 2e-2). Tolerances, tighter than ``tests/test_fused_train.py:97-115``
(which holds the TPU kernel to the XLA path): per-step losses 5e-6
absolute; Adam moments 1e-6; BatchNorm running statistics and parameters
1e-5 (both packages run the same float32 arithmetic, summed in other
orders). The dropout masks are the same lowbias32 hash in both, so the
MC-dropout epochs are held to the same tolerances: a single differing
mask element would move the losses far past them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnueehcs_tpu.model_builder import (EnsembleModelBuilder,
                                        MCDropoutModelBuilder,
                                        MVEModelBuilder)
from nnueehcs_tpu.nn.network import build_network as jax_build_network
from nnueehcs_tpu.ops import fused_train as ft
from nnueehcs_tpu_torch.convert import tensor_trees
from nnueehcs_tpu_torch.nn.network import build_network
from nnueehcs_tpu_torch.ops import fused_train as pt

from torch_parity import descr, port_of, randomize_params, randomize_state

TOL_LOSS = {'rtol': 0, 'atol': 5e-6}
TOL_MOMENT = {'rtol': 0, 'atol': 1e-6}
TOL_PARAM = {'rtol': 0, 'atol': 1e-5}
S, B = 6, 16


def _jax_model(kind, loss='l1_loss', per_member=False, p=0.2, members=3):
    # MVE trains on the NLL whatever loss its configuration names
    tc = {'loss': 'l1_loss' if loss == 'gaussian_nll' else loss}
    if per_member:
        tc['ensemble_loss'] = 'per_member'
    if kind == 'ensemble':
        m = EnsembleModelBuilder(descr(), {'num_models': members},
                                 train_config=tc).build()
    elif kind == 'mve':
        m = MVEModelBuilder(descr(), {}, train_config=tc).build()
    else:
        m = MCDropoutModelBuilder(descr(hidden=3), {
            'num_samples': 4, 'dropout_percent': p}, train_config=tc).build()
    m.params = randomize_params(m.params, 1)
    m.state = randomize_state(m.state, 2)
    m.invalidate_cache()
    return m


def _plans(m, members, loss, per_member=False, clip=5.0, wd=0.0):
    stacked = type(m).__name__ == 'EnsembleModel'
    kw = dict(loss=loss, per_member=per_member, clip=clip, weight_decay=wd,
              member_stacked=stacked)
    plan = ft.plan_fused_train(m.net, members, B, **kw)
    pplan = pt.plan_fused_train(port_of(m).net, members, B, **kw)
    assert plan is not None and pplan is not None
    return plan, pplan


def _moments(plan, params, seed):
    rng = np.random.default_rng(seed)
    mu = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=a.shape) * 1e-2, jnp.float32),
        params)
    nu = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(1e-5, 1e-3, a.shape), jnp.float32),
        params)
    return ft.pack_tree(plan, mu), ft.pack_tree(plan, nu)


def _batches(plan, d=5, seed=0, steps=S):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(steps * B, d)).astype(np.float32)
    y = (np.sin(x).sum(1, keepdims=True)
         + 0.1 * rng.normal(size=(steps * B, 1))).astype(np.float32)
    return ft.gather_epoch_batches(plan, jnp.asarray(x), jnp.asarray(y),
                                   jnp.arange(steps * B))


def _torch(*arrays):
    return [torch.tensor(np.array(a)) for a in arrays]


def _assert_epochs_agree(jax_out, port_out):
    names = ('theta', 'm', 'v', 'sigma', 'losses')
    tols = (TOL_PARAM, TOL_MOMENT, TOL_MOMENT, TOL_PARAM, TOL_LOSS)
    for name, a, b, tol in zip(names, jax_out, port_out, tols):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=name,
                                   **tol)


CASES = {
    # name: (kind, loss, per_member, weight decay, dropout rate, members)
    'joint_l1_clip': ('ensemble', 'l1_loss', False, 0.0, None, 3),
    'mse_wd': ('ensemble', 'mse_loss', False, 0.01, None, 3),
    'per_member_l1': ('ensemble', 'l1_loss', True, 0.0, None, 3),
    'mve_nll': ('mve', 'gaussian_nll', False, 0.0, None, 1),
    'mc_dropout_p02': ('mc', 'l1_loss', False, 0.0, 0.2, 1),
    'mc_dropout_p1': ('mc', 'l1_loss', False, 0.0, 1.0, 1),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_epoch_matches_jax_kernel(case):
    kind, loss, per_member, wd, p, members = CASES[case]
    m = _jax_model(kind, loss, per_member, p or 0.2, members)
    plan, pplan = _plans(m, members, loss, per_member, wd=wd)
    theta = ft.pack_tree(plan, m.params)
    sigma = ft.pack_state(plan, m.state)
    mu, nu = _moments(plan, m.params, 3)
    xs, ys = _batches(plan)
    drops = ft.drop_rates(m.net)
    port_in = _torch(theta, mu, nu, sigma, xs, ys)
    out = ft.fused_epoch(plan, theta, mu, nu, sigma, xs, ys, 1e-3, 4,
                         seed=20250, drops=drops, interpret=True)
    got = pt.fused_epoch(pplan, *port_in, 1e-3, 4, seed=20250,
                         drops=pt.drop_rates(port_of(m).net))
    _assert_epochs_agree(out, got)
    if p is not None:
        np.testing.assert_array_equal(pt.drop_rates(port_of(m).net).numpy(),
                                      np.asarray(drops).ravel())


def test_step0_continues_across_two_epochs():
    """Adam's bias correction carries on from ``step0``: two epochs of 3
    steps in each package, the second started where the first ended."""
    m = _jax_model('ensemble', members=2)
    plan, pplan = _plans(m, 2, 'l1_loss')
    theta = ft.pack_tree(plan, m.params)
    sigma = ft.pack_state(plan, m.state)
    mu, nu = _moments(plan, m.params, 4)
    xs, ys = _batches(plan, seed=1)
    bufs = _torch(theta, mu, nu, sigma)
    jax_losses, port_losses = [], []
    for lo in (0, 3):
        theta, mu, nu, sigma, l_j = ft.fused_epoch(
            plan, theta, mu, nu, sigma, xs[lo:lo + 3], ys[lo:lo + 3], 1e-3,
            lo, interpret=True)
        *bufs, l_p = pt.fused_epoch(pplan, *bufs, *_torch(xs[lo:lo + 3],
                                                          ys[lo:lo + 3]),
                                    1e-3, lo)
        jax_losses.append(np.asarray(l_j))
        port_losses.append(l_p.numpy())
    np.testing.assert_allclose(np.concatenate(port_losses),
                               np.concatenate(jax_losses), **TOL_LOSS)
    _assert_epochs_agree((theta, mu, nu, sigma, l_j), (*bufs, l_p))


def _nets():
    bn = descr(in_dim=5, width=16, hidden=1)
    return {
        'flagship_like': descr(in_dim=5, width=32, hidden=2),
        'dropout_before_linear': [{'Linear': {'args': [5, 16]}},
                                  {'BatchNorm1d': {'args': [16]}},
                                  {'Dropout': {'args': [0.1]}},
                                  {'Linear': {'args': [16, 1]}}],
        'trailing_dropout': bn + [{'Dropout': {'args': [0.1]}}],
        'no_bn_hidden': [{'Linear': {'args': [5, 16]}}, {'ReLU': {}},
                         {'Linear': {'args': [16, 1]}}],
        'too_wide': descr(in_dim=5, width=256, hidden=1),
        'wide_input': descr(in_dim=200, width=16, hidden=1),
        'no_bias': [{'Linear': {'args': [5, 16], 'bias': False}},
                    {'BatchNorm1d': {'args': [16]}}, {'ReLU': {}},
                    {'Linear': {'args': [16, 1]}}],
        'bn_last': bn[:-1] + [{'Linear': {'args': [16, 3]}},
                              {'BatchNorm1d': {'args': [3]}}],
        'mve_head': descr(in_dim=7, width=24, hidden=3, out_dim=2),
        'odd_eps': [{'Linear': {'args': [5, 16]}},
                    {'BatchNorm1d': {'args': [16], 'eps': 1e-3}},
                    {'ReLU': {}}, {'Linear': {'args': [16, 16]}},
                    {'BatchNorm1d': {'args': [16]}}, {'ReLU': {}},
                    {'Linear': {'args': [16, 1]}}],
    }


@pytest.mark.parametrize('name', sorted(_nets()))
@pytest.mark.parametrize('config', [
    dict(members=2, batch=16),
    dict(members=1, batch=24, loss='gaussian_nll', member_stacked=False),
    dict(members=3, batch=12),
    dict(members=2, batch=16, loss='huber_loss'),
    dict(members=2, batch=8, loss='mse_loss', per_member=True, clip=1.0,
         weight_decay=0.01),
])
def test_plan_matches_jax(name, config):
    arch = _nets()[name]
    config = dict(config)
    members = config.pop('members')
    batch = config.pop('batch')
    want = ft.plan_fused_train(jax_build_network(arch), members, batch,
                               **config)
    got = pt.plan_fused_train(build_network(arch), members, batch, **config)
    if want is None:
        assert got is None
        return
    assert got is not None
    for field in ('slab_rows', 'sig_rows', 'num_members', 'batch', 'in_pad',
                  'out_pad', 'n_bn', 'bn_eps', 'bn_mom', 'loss', 'per_member',
                  'clip', 'weight_decay', 'member_stacked', 'n_drop'):
        assert getattr(got, field) == getattr(want, field), field
    assert [tuple(vars(L).values()) for L in got.lins] == \
        [tuple(vars(L).values()) for L in want.lins]


def test_plan_has_no_vmem_budget():
    """The JAX plan refuses thousands of members (its VMEM budget); the
    port's buffers live in device memory, so it takes them."""
    net = descr(in_dim=5, width=32, hidden=2)
    assert ft.plan_fused_train(jax_build_network(net), 4096, 16) is None
    assert pt.plan_fused_train(build_network(net), 4096, 16) is not None


@pytest.mark.parametrize('kind', ['ensemble', 'mve', 'mc'])
def test_pack_tree_and_state_equal_jax_bit_for_bit(kind):
    members = 3 if kind == 'ensemble' else 1
    loss = 'gaussian_nll' if kind == 'mve' else 'l1_loss'
    m = _jax_model(kind, loss, members=members)
    plan, pplan = _plans(m, members, loss)
    port = port_of(m)
    params, state = tensor_trees(port.net)
    np.testing.assert_array_equal(pt.pack_tree(pplan, params).numpy(),
                                  np.asarray(ft.pack_tree(plan, m.params)))
    np.testing.assert_array_equal(pt.pack_state(pplan, state).numpy(),
                                  np.asarray(ft.pack_state(plan, m.state)))
    # and back: the views unpack to the module tensors
    theta = pt.pack_tree(pplan, params)
    for a, b in zip(pt.unpack_tree(pplan, theta, len(port.net.layers)),
                    params):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k].detach())
    sigma = pt.pack_state(pplan, state)
    for a, b in zip(pt.unpack_state(pplan, sigma, len(port.net.layers)),
                    state):
        for k in a:
            assert torch.equal(a[k], b[k])


def test_dropout_mask_keeps_the_rate_and_repeats():
    rate = torch.tensor(0.25)
    a = pt.dropout_mask(1234, 3, 0, 1, rate, 256, 128, 'cpu')
    b = pt.dropout_mask(1234, 3, 0, 1, rate, 256, 128, 'cpu')
    c = pt.dropout_mask(1234, 4, 0, 1, rate, 256, 128, 'cpu')
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(torch.unique(a).tolist()) == {0.0, float(np.float32(1 / 0.75))}
    assert abs(float((a > 0).float().mean()) - 0.75) < 0.01
    zero = pt.dropout_mask(1, 0, 0, 0, torch.tensor(1.0), 8, 8, 'cpu')
    assert torch.equal(zero, torch.zeros(8, 8))


def test_fused_epoch_checks_its_inputs():
    net = build_network(descr())
    plan = pt.plan_fused_train(net, 1, B, member_stacked=False)
    params, state = tensor_trees(net)
    theta = pt.pack_tree(plan, params)
    sigma = pt.pack_state(plan, state)
    xs = torch.zeros(2, B, plan.in_pad)
    ys = torch.zeros(2, B, plan.out_pad)
    zeros = torch.zeros_like(theta)
    before = pt.fused_epoch.launches
    out = pt.fused_epoch(plan, theta, zeros, zeros.clone(), sigma, xs, ys,
                         1e-3, 0)
    assert out[4].shape == (2,) and pt.fused_epoch.launches == before
    with pytest.raises(ValueError, match='xs'):
        pt.fused_epoch(plan, theta, zeros, zeros, sigma, xs[:, :8], ys,
                       1e-3, 0)
    with pytest.raises(TypeError, match='float32'):
        pt.fused_epoch(plan, theta.double(), zeros, zeros, sigma, xs, ys,
                       1e-3, 0)
    with pytest.raises(NotImplementedError, match='fp32'):
        pt.fused_epoch(plan, theta, zeros, zeros, sigma, xs.bfloat16(), ys,
                       1e-3, 0)
    with pytest.raises(ValueError, match='dropout rates'):
        pt.fused_epoch(plan, theta, zeros, zeros, sigma, xs, ys, 1e-3, 0,
                       drops=[0.1, 0.2])


def test_plain_epoch_records_relu_decisions():
    """``signs`` receives the backward's ReLU decisions (step, member,
    BatchNorm slot, row, lane) and changes nothing else: the first block's
    decisions at step 0 are those of the port's own training-mode
    forward."""
    m = _jax_model('mve', 'gaussian_nll')
    plan, pplan = _plans(m, 1, 'gaussian_nll')
    net = port_of(m).net
    bufs = _torch(ft.pack_tree(plan, m.params), *_moments(plan, m.params, 3),
                  ft.pack_state(plan, m.state))
    xs, ys = _torch(*_batches(plan))
    signs = torch.full((S, 1, pplan.n_bn, B, pt.LANES), 7, dtype=torch.uint8)
    plain = pt.fused_epoch(pplan, *[b.clone() for b in bufs], xs, ys, 1e-3,
                           4)
    got = pt.fused_epoch(pplan, *[b.clone() for b in bufs], xs, ys, 1e-3, 4,
                         signs=signs)
    for a, b in zip(plain, got):
        assert torch.equal(a, b)
    width = net.layers[0].out_features
    assert set(signs.unique().tolist()) == {0, 1}
    assert not signs[..., width:].any()
    with torch.no_grad():
        net.train()
        first = net.layers[1](net.layers[0](xs[0, :, :5]))
    np.testing.assert_array_equal(signs[0, 0, 0, :, :width].numpy(),
                                  (first > 0).numpy())
    with pytest.raises(ValueError, match='signs'):
        pt.fused_epoch(pplan, *bufs, xs, ys, 1e-3, 4, signs=signs[:1])


def test_flip_reach_and_stepwise_check_on_the_cpu():
    """``chip_smoke.flip_reach`` marks the flipped block's column and every
    row of the member's earlier blocks, nothing of other members; and the
    step-by-step check passes with no flip when both sides are the plain
    epoch."""
    from chip_smoke import flip_reach, stepwise_vs_plain
    m = _jax_model('ensemble', members=3)
    plan, pplan = _plans(m, 3, 'l1_loss')
    flips = torch.zeros((3, pplan.n_bn, B, pt.LANES), dtype=torch.bool)
    flips[1, 1, 4, 9] = True
    reach = flip_reach(pplan, flips).reshape(3, pplan.slab_rows, pt.LANES)
    L = pplan.lins[1]
    want = torch.zeros_like(reach[1])
    want[:L.w_off] = True
    want[[*range(L.w_off, L.w_off + L.in_rows), L.b_off, L.g_off,
          L.be_off], 9] = True
    assert torch.equal(reach[1], want)
    assert not reach[0].any() and not reach[2].any()
    bufs = _torch(ft.pack_tree(plan, m.params), *_moments(plan, m.params, 3),
                  ft.pack_state(plan, m.state))
    xs, ys = _torch(*_batches(plan, steps=2))
    out = stepwise_vs_plain(pplan, bufs, xs, ys, 1e-3, 4, 5,
                            pt.drop_rates(port_of(m).net))
    assert out['steps'] == 2 and out['flips'] == 0 and out['over_tol'] == 0
    assert out['loss_flips'] == 0
