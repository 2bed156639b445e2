"""The port's loss registry (``nnueehcs_tpu_torch/ops/losses.py``) against
the JAX package's (``nnueehcs_tpu/ops/losses.py``): values and gradients
on the same numpy inputs, including differences of exactly zero, where
``jax.grad(jnp.abs)`` is +1 and torch's ``abs`` would give 0. Tolerance:
1e-6 absolute and relative (float32 reductions summed in other orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnueehcs_tpu.models.mve import gaussian_nll as jax_nll
from nnueehcs_tpu.ops import losses as jl
from nnueehcs_tpu_torch.models.mve import gaussian_nll as port_nll
from nnueehcs_tpu_torch.ops import losses as pl

TOL = {'rtol': 1e-6, 'atol': 1e-6}


def _inputs(name):
    rng = np.random.default_rng(0)
    pred = rng.normal(size=(16, 3)).astype(np.float32)
    target = rng.normal(size=(16, 3)).astype(np.float32)
    target[:4] = pred[:4]                         # exact zeros of pred - target
    if name == 'binary_cross_entropy':
        pred = 1 / (1 + np.exp(-pred))
        target = (target > 0).astype(np.float32)
    if name == 'cross_entropy':
        target = rng.integers(0, 3, size=16)
    return pred, target


@pytest.mark.parametrize('name', sorted(jl.LOSS_REGISTRY))
def test_loss_and_gradient_match_jax(name):
    assert sorted(pl.LOSS_REGISTRY) == sorted(jl.LOSS_REGISTRY)
    pred, target = _inputs(name)
    want, want_grad = jax.value_and_grad(jl.get_loss_fn(name))(
        jnp.asarray(pred), jnp.asarray(target))
    p = torch.tensor(pred, requires_grad=True)
    got = pl.get_loss_fn(name)(p, torch.tensor(target))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad), **TOL)


def test_l1_gradient_is_plus_one_at_zero():
    x = torch.zeros(4, requires_grad=True)
    pl.l1_loss(x, torch.zeros(4)).backward()
    assert torch.equal(x.grad, torch.full((4,), 0.25))


def test_gaussian_nll_matches_jax():
    rng = np.random.default_rng(1)
    out = rng.normal(size=(32, 2)).astype(np.float32) * 3
    y = rng.normal(size=(32, 1)).astype(np.float32)
    want, want_grad = jax.value_and_grad(jax_nll)(jnp.asarray(out),
                                                  jnp.asarray(y))
    o = torch.tensor(out, requires_grad=True)
    got = port_nll(o, torch.tensor(y))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(want_grad), **TOL)


def test_unknown_loss_raises():
    with pytest.raises(ValueError, match='Unknown loss'):
        pl.get_loss_fn('nope')
