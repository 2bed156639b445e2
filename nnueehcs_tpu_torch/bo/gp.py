"""A small Gaussian process for the BO engine, in torch float32.

Counterpart of ``nnueehcs_tpu/bo/gp.py``: a Matérn-5/2 ARD kernel with
sigmoid-bounded hyperparameters (lengthscales in [0.03, 5], amplitude in
[0.05, 20], noise in [1e-4, 1]; inits -2.9, -3.0 and -4.6 in sigmoid space,
about 0.3, 1 and 1e-2) and a 1e-6 jitter, fitted by 200 steps of Adam
(learning rate 0.05, b1 0.9, b2 0.999, eps 1e-8, bias-corrected: the JAX
package's ``optax.adam(0.05)``, written out) on the negative log marginal
likelihood, its gradient from autograd; then the posterior and expected
improvement over candidate points. It runs on the CPU, as the JAX one
does: its matrices are at most a few dozen points (the BO budget), and on
the card every suggestion would pay launches for microseconds of work.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_JITTER = 1e-6
_DTYPE = torch.float32
FIT_STEPS = 200
LEARNING_RATE, B1, B2, EPS = 0.05, 0.9, 0.999, 1e-8


def _matern52(x1, x2, lengthscales, amplitude):
    d = (x1[:, None, :] - x2[None, :, :]) / lengthscales
    r = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)
    sqrt5r = math.sqrt(5.0) * r
    return amplitude * (1.0 + sqrt5r + 5.0 / 3.0 * r * r) * torch.exp(-sqrt5r)


def _bounded(raw, lo, hi):
    """Sigmoid-bounded positive hyperparameter: keeps the float32 Cholesky
    well conditioned wherever the optimiser wanders."""
    return lo + (hi - lo) * torch.sigmoid(raw)


def _unpack(theta, dim):
    lengthscales = _bounded(theta[:dim], 0.03, 5.0)
    amplitude = _bounded(theta[dim], 0.05, 20.0)
    noise = _bounded(theta[dim + 1], 1e-4, 1.0)
    return lengthscales, amplitude, noise


def _cholesky(theta, x):
    n, dim = x.shape
    ls, amp, noise = _unpack(theta, dim)
    k = _matern52(x, x, ls, amp) + (noise + _JITTER) * torch.eye(n, dtype=_DTYPE)
    return torch.linalg.cholesky(k), ls, amp


def _nll(theta, x, y):
    n = x.shape[0]
    chol, _, _ = _cholesky(theta, x)
    alpha = torch.cholesky_solve(y[:, None], chol)[:, 0]
    return (0.5 * torch.dot(y, alpha)
            + torch.sum(torch.log(torch.diagonal(chol)))
            + 0.5 * n * math.log(2 * math.pi))


def initial_theta(dim: int) -> torch.Tensor:
    return torch.tensor([-2.9] * dim + [-3.0, -4.6], dtype=_DTYPE)


def fit(x: torch.Tensor, y: torch.Tensor, steps: int = FIT_STEPS):
    """``(theta, nll)``: the hyperparameters after ``steps`` Adam steps on
    the NLL, and the NLL at the last step's start (as the JAX package's
    scan reports it)."""
    theta = initial_theta(x.shape[1])
    mu = torch.zeros_like(theta)
    nu = torch.zeros_like(theta)
    loss = None
    for count in range(1, steps + 1):
        theta.requires_grad_(True)
        loss = _nll(theta, x, y)
        (grad,) = torch.autograd.grad(loss, theta)
        with torch.no_grad():
            mu = (1 - B1) * grad + B1 * mu
            nu = (1 - B2) * (grad * grad) + B2 * nu
            t = torch.tensor(float(count), dtype=_DTYPE)
            mu_hat = mu / (1 - torch.tensor(B1, dtype=_DTYPE) ** t)
            nu_hat = nu / (1 - torch.tensor(B2, dtype=_DTYPE) ** t)
            theta = theta.detach() + (-LEARNING_RATE) * (
                mu_hat / (torch.sqrt(nu_hat) + EPS))
    return theta, float(loss.detach())


@torch.no_grad()
def posterior(theta, x, y, x_star):
    """Posterior mean and variance (floored at 1e-12) at ``x_star``."""
    chol, ls, amp = _cholesky(theta, x)
    k_star = _matern52(x_star, x, ls, amp)
    alpha = torch.cholesky_solve(y[:, None], chol)[:, 0]
    mean = k_star @ alpha
    v = torch.linalg.solve_triangular(chol, k_star.T, upper=False)
    var = amp - torch.sum(v * v, dim=0)
    return mean, torch.clamp(var, min=1e-12)


@torch.no_grad()
def expected_improvement(mean, var, best):
    """EI for *minimisation* of the standardised objective."""
    sigma = torch.sqrt(var)
    gamma = (best - mean) / sigma
    phi = torch.exp(-0.5 * gamma * gamma) / math.sqrt(2 * math.pi)
    cdf = 0.5 * (1 + torch.erf(gamma / math.sqrt(2.0)))
    return sigma * (gamma * cdf + phi)


class GaussianProcess:
    """Fit once, then query posterior/EI. Inputs in [0,1]^d, y standardised
    internally (minimisation convention)."""

    def __init__(self, x: np.ndarray, y: np.ndarray):
        self.x = torch.as_tensor(np.asarray(x), dtype=_DTYPE)
        y = np.asarray(y, np.float64)
        self.y_mean = float(y.mean())
        self.y_std = float(y.std()) or 1.0
        self.y = torch.as_tensor((y - self.y_mean) / self.y_std, dtype=_DTYPE)
        self.theta, self.final_nll = fit(self.x, self.y)

    def _posterior(self, x_star):
        return posterior(self.theta, self.x, self.y,
                         torch.as_tensor(np.asarray(x_star), dtype=_DTYPE))

    def posterior(self, x_star: np.ndarray):
        mean, var = self._posterior(x_star)
        return (mean.numpy() * self.y_std + self.y_mean,
                var.numpy() * self.y_std ** 2)

    def expected_improvement(self, x_star: np.ndarray,
                             best_y: float | None = None) -> np.ndarray:
        """EI toward minimisation. ``best_y`` overrides the incumbent (in
        the *original* y units): constrained EI needs the best *feasible*
        observation, not the global best."""
        mean, var = self._posterior(x_star)
        if best_y is None:
            best = torch.min(self.y)
        else:
            best = torch.tensor((best_y - self.y_mean) / self.y_std,
                                dtype=_DTYPE)
        return expected_improvement(mean, var, best).numpy()
