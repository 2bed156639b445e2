"""The port's BO engine (``nnueehcs_tpu_torch/bo``) against the JAX
package's: the search space, the Sobol stream, the GP (torch float32
against JAX float32), the suggestions, the Pareto export and the JSON state,
which either package resumes.

Tolerances: the GP's posterior and EI at the same hyperparameters within
5e-4 (standardised units: float32 Cholesky solves of a dozen points in two
libraries); the fitted hyperparameters within 2e-3 in sigmoid space (200
float32 Adam steps on gradients that differ in their last bits)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnueehcs_tpu.bo import client as jax_client
from nnueehcs_tpu.bo import gp as jax_gp
from nnueehcs_tpu.bo import space as jax_space
from nnueehcs_tpu_torch.bo import client, gp, space

from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

TOL_POSTERIOR = 5e-4
TOL_THETA = 2e-3
PARAMETERS = [
    {'name': 'num_models', 'type': 'range', 'bounds': [2, 32]},
    {'name': 'anchored_batch_size', 'type': 'range', 'bounds': [64, 131072],
     'log_scale': True},
    {'name': 'dropout_percent', 'type': 'range', 'bounds': [0.05, 0.3]},
    {'name': 'bandwidth', 'type': 'choice', 'values': ['scott', 'silverman']},
    {'name': 'estimator', 'type': 'fixed', 'value': 'std'},
    {'name': 'learning_rate', 'type': 'fixed', 'value': 5e-5}]


def test_space_maps_as_jax_and_round_trips():
    ours, theirs = space.ParameterSpace(PARAMETERS), \
        jax_space.ParameterSpace(PARAMETERS)
    assert ours.dim == theirs.dim == 4 and ours.names() == theirs.names()
    rng = np.random.default_rng(0)
    for u in [np.zeros(4), np.ones(4), *rng.uniform(size=(50, 4))]:
        params = ours.from_unit(u)
        assert params == theirs.from_unit(u)
        assert np.array_equal(ours.to_unit(params), theirs.to_unit(params))
        assert ours.from_unit(ours.to_unit(params)) == params


@pytest.mark.parametrize('n,skip,d,offset', [(1, 0, None, 0), (1, 7, None, 0),
                                             (64, 0, 3, 5), (2048, 0, 2, 1)])
def test_the_same_sobol_points(n, skip, d, offset):
    ours, theirs = client.BOClient(seed=3), jax_client.BOClient(seed=3)
    for c in (ours, theirs):
        c.create_experiment('s', PARAMETERS[:3],
                            {'m': client.ObjectiveProperties(True)})
    assert np.array_equal(ours._sobol_points(n, skip, d, offset),
                          theirs._sobol_points(n, skip, d, offset))


@pytest.fixture(scope='module')
def gp_data():
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(12, 3))
    y = np.sin(3 * x).sum(1) + 0.1 * rng.normal(size=12)
    return x, y, rng.uniform(size=(300, 3))


def test_posterior_and_ei_at_fixed_theta(gp_data):
    x, y, x_star = gp_data
    theirs = jax_gp.GaussianProcess(x, y)
    theta = np.asarray(theirs.theta)
    mean_j, var_j = jax_gp._posterior(jnp.asarray(theta), theirs.x, theirs.y,
                                      jnp.asarray(x_star, jnp.float32))
    args = [torch.tensor(np.asarray(a)) for a in (theta, theirs.x, theirs.y)]
    mean_t, var_t = gp.posterior(*args, torch.tensor(x_star,
                                                     dtype=torch.float32))
    assert np.abs(mean_t.numpy() - np.asarray(mean_j)).max() < TOL_POSTERIOR
    assert np.abs(var_t.numpy() - np.asarray(var_j)).max() < TOL_POSTERIOR
    best = float(np.min(np.asarray(theirs.y)))
    ei_j = jax_gp._expected_improvement(mean_j, var_j, best)
    ei_t = gp.expected_improvement(mean_t, var_t, torch.tensor(best))
    assert np.abs(ei_t.numpy() - np.asarray(ei_j)).max() < TOL_POSTERIOR
    nll_j = float(jax_gp._nll(jnp.asarray(theta), theirs.x, theirs.y))
    nll_t = float(gp._nll(*args))
    assert abs(nll_t - nll_j) < TOL_POSTERIOR * max(1.0, abs(nll_j))


def test_fitted_theta_and_queries(gp_data):
    x, y, x_star = gp_data
    ours, theirs = gp.GaussianProcess(x, y), jax_gp.GaussianProcess(x, y)
    assert ours.theta.dtype == torch.float32
    assert np.abs(ours.theta.numpy() - np.asarray(theirs.theta)).max() \
        < TOL_THETA
    assert abs(ours.final_nll - float(theirs.final_nll)) < TOL_THETA * max(
        1.0, abs(float(theirs.final_nll)))
    scale = float(np.std(y))
    for a, b in zip(ours.posterior(x_star), theirs.posterior(x_star)):
        assert np.abs(a - b).max() < 10 * TOL_POSTERIOR * max(scale, scale ** 2)
    ei_o = ours.expected_improvement(x_star, best_y=float(y.min()) + 0.1)
    ei_t = theirs.expected_improvement(x_star, best_y=float(y.min()) + 0.1)
    assert np.abs(ei_o - ei_t).max() < 10 * TOL_POSTERIOR


def objective(params):
    return ((params['dropout_percent'] - 0.12) ** 2
            + (np.log(params['anchored_batch_size']) - 8.0) ** 2 / 50)


def run_client(cls, trials, objectives=None, constraints=None, seed=0):
    c = cls(seed=seed)
    c.create_experiment('t', PARAMETERS[1:3],
                        objectives or {'m': client.ObjectiveProperties(True)},
                        outcome_constraints=constraints)
    for _ in range(trials):
        params, index = c.get_next_trial()
        value = objective(params)
        raw = {'m': (value, 0.0)}
        if objectives and 'n' in objectives:
            raw['n'] = (params['dropout_percent'], 0.01)
        if constraints:
            raw['c'] = value * 10
        c.complete_trial(index, raw)
    return c


def ei_margin(c):
    """The JAX client's EI over the candidates of its next suggestion: the
    best candidate's lead over the runner-up, relative to the best."""
    index = len(c.trials)
    xs, y, _ = c._scalarized_targets(index)
    model = jax_gp.GaussianProcess(xs, y)
    candidates = c._sobol_points(2048, seed_offset=1 + index)
    rng = np.random.default_rng(c.seed * 104729 + index)
    local = np.clip(xs[int(np.argmin(y))]
                    + rng.normal(scale=0.05, size=(256, xs.shape[1])), 0, 1)
    ei = np.sort(model.expected_improvement(
        np.concatenate([candidates, local])))
    return (ei[-1] - ei[-2]) / ei[-1]


@pytest.mark.parametrize('trials', [6, 8])
def test_the_same_suggestion_where_ei_peaks_clearly(trials):
    theirs = run_client(jax_client.BOClient, trials)
    ours = run_client(client.BOClient, trials)
    assert [t['params'] for t in ours.trials] == \
        [t['params'] for t in theirs.trials]
    assert ei_margin(theirs) > 1e-3
    assert ours.get_next_trial() == theirs.get_next_trial()


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_json_state_resumes_in_the_other_package(tmp_path, writer):
    pkgs = {'port': client.BOClient, 'jax': jax_client.BOClient}
    reader = 'jax' if writer == 'port' else 'port'
    c = run_client(pkgs[writer], 6)
    params, index = c.get_next_trial()
    c.log_trial_failure(index)
    path = str(tmp_path / 'ax_client.json')
    c.save_to_json_file(path)
    resumed = pkgs[reader].load_from_json_file(path)
    with open(path) as f:
        assert json.load(f)['engine'] == 'nnueehcs_tpu-bo-v1'
    assert resumed.trials == c.trials
    assert resumed.to_json_dict() == c.to_json_dict()
    assert resumed.get_next_trial() == c.get_next_trial()


@pytest.mark.parametrize('use_model_predictions', [False, True])
def test_pareto_export_matches(use_model_predictions):
    objectives = {'m': client.ObjectiveProperties(True),
                  'n': client.ObjectiveProperties(False)}
    ours = run_client(client.BOClient, 7, objectives)
    theirs = run_client(jax_client.BOClient, 7, objectives)
    a = ours.get_pareto_optimal_parameters(use_model_predictions)
    b = theirs.get_pareto_optimal_parameters(use_model_predictions)
    assert sorted(a) == sorted(b)
    # observed means are the same numbers; the model's are posteriors of
    # GPs fitted apart (TOL_THETA), held to 1e-2 relative
    rtol = 1e-2 if use_model_predictions else 0.0
    for k in a:
        assert a[k][0] == b[k][0]
        for got, want in zip(a[k][1], b[k][1]):
            for name in got:
                g = got[name] if not isinstance(got[name], dict) \
                    else got[name][name]
                w = want[name] if not isinstance(want[name], dict) \
                    else want[name][name]
                assert abs(g - w) <= rtol * max(1e-3, abs(w))


def test_constrained_suggestion_matches():
    ours = run_client(client.BOClient, 6, constraints=['c <= 0.05'])
    theirs = run_client(jax_client.BOClient, 6, constraints=['c <= 0.05'])
    assert ours.get_next_trial() == theirs.get_next_trial()
    with pytest.raises(ValueError, match='Cannot parse'):
        client.BOClient().create_experiment(
            't', PARAMETERS[:1], {'m': client.ObjectiveProperties(True)},
            outcome_constraints=['c < 1'])
