"""Bayesian-optimization client with the Ax client surface.

Counterpart of ``nnueehcs_tpu/bo/client.py``, with the same surface
(``create_experiment / get_next_trial / complete_trial / log_trial_failure
/ save_to_json_file / load_from_json_file / get_pareto_optimal_parameters``)
and the same engine:

- scrambled Sobol initialisation (``max(5, 2·dim)`` points) from
  ``scipy.stats.qmc.Sobol``, imported when first drawn, so that both
  packages draw the same points (``torch.quasirandom.SobolEngine`` draws
  another sequence),
- then GP expected improvement (the Matérn-5/2 GP of :mod:`.gp`) over a
  Sobol candidate sweep,
- multi-objective via random-weight augmented-Chebyshev scalarisation with
  per-trial deterministic weights, and exact Pareto extraction over observed
  trials,
- outcome constraints (Ax string syntax ``"metric <= bound"``) via
  probability-of-feasibility-weighted EI with a GP per constrained metric,
  and feasibility filtering of the Pareto set,
- ``get_pareto_optimal_parameters(use_model_predictions=True)`` extracts the
  front over per-objective GP posterior means at the observed points.

The JSON state is the JAX package's (``engine: nnueehcs_tpu-bo-v1``): a
state written by either package resumes in the other.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from .space import ParameterSpace


@dataclasses.dataclass
class ObjectiveProperties:
    minimize: bool


class BOClient:
    def __init__(self, seed: int = 0):
        self.seed = seed
        self.experiment_name = None
        self.space: Optional[ParameterSpace] = None
        self.objectives: Dict[str, ObjectiveProperties] = {}
        self.tracking_metric_names: List[str] = []
        self.outcome_constraints: List = []
        self._constraints: List[tuple] = []
        self.trials: List[dict] = []

    # ----------------------------------------------------------- experiment
    def create_experiment(self, name: str, parameters: List[dict],
                          objectives: Dict[str, ObjectiveProperties],
                          tracking_metric_names: Optional[List[str]] = None,
                          outcome_constraints: Optional[List] = None):
        self.experiment_name = name
        self.space = ParameterSpace(parameters)
        self.objectives = dict(objectives)
        self.tracking_metric_names = list(tracking_metric_names or [])
        self.outcome_constraints = list(outcome_constraints or [])
        # fail loudly on constraints we cannot honor, instead of silently
        # optimizing an unconstrained problem
        self._constraints = [_parse_outcome_constraint(c)
                             for c in self.outcome_constraints]

    # ---------------------------------------------------------------- trials
    @property
    def num_init_trials(self) -> int:
        return max(5, 2 * self.space.dim)

    def _sobol_points(self, n: int, skip: int = 0, d: Optional[int] = None,
                      seed_offset: int = 0) -> np.ndarray:
        from scipy.stats import qmc
        d = d if d is not None else max(self.space.dim, 1)
        sampler = qmc.Sobol(d=d, scramble=True, seed=self.seed + seed_offset)
        if skip:
            sampler.fast_forward(skip)
        return sampler.random(n)

    def get_next_trial(self) -> Tuple[dict, int]:
        if self.space is None:
            raise RuntimeError('create_experiment must be called first')
        index = len(self.trials)
        if self.space.dim == 0:
            params = self.space.from_unit(np.zeros(0))
        else:
            n_generated = index
            if n_generated < self.num_init_trials or not self._has_model_data():
                u = self._sobol_points(1, skip=n_generated)[0]
            else:
                u = self._suggest_gp(index)
            params = self.space.from_unit(u)
        self.trials.append({'index': index, 'params': params,
                            'status': 'running', 'raw_data': {}})
        return dict(params), index

    def _has_model_data(self) -> bool:
        return sum(t['status'] == 'completed' for t in self.trials) >= 3

    def _objective_matrix(self):
        """(n, m) objective means over completed trials, sign-flipped so
        *smaller is better* for every column."""
        completed = [t for t in self.trials if t['status'] == 'completed']
        names = list(self.objectives)
        ys = np.array([[t['raw_data'][n][0] for n in names] for t in completed],
                      dtype=np.float64)
        for j, n in enumerate(names):
            if not self.objectives[n].minimize:
                ys[:, j] = -ys[:, j]
        return completed, names, ys

    def _scalarized_targets(self, trial_index: int):
        """(xs, scalarised y, feasible mask) over completed finite trials."""
        completed, names, ys = self._objective_matrix()
        xs = np.array([self.space.to_unit(t['params']) for t in completed])
        finite = np.all(np.isfinite(ys), axis=1)
        feasible = np.array([self._is_feasible(t['raw_data'])
                             for t in completed], dtype=bool)
        xs, ys, feasible = xs[finite], ys[finite], feasible[finite]
        if ys.shape[1] == 1:
            return xs, ys[:, 0], feasible
        # normalise each objective to [0,1] over observations
        lo = ys.min(axis=0)
        hi = ys.max(axis=0)
        z = (ys - lo) / np.where(hi - lo > 0, hi - lo, 1.0)
        rng = np.random.default_rng(self.seed * 7919 + trial_index)
        w = rng.dirichlet(np.ones(ys.shape[1]))
        # augmented Chebyshev scalarisation
        scalar = np.max(w * z, axis=1) + 0.05 * np.sum(w * z, axis=1)
        return xs, scalar, feasible

    def _metric_observations(self, metric: str):
        """(xs, values) over completed trials where ``metric`` was reported
        finite."""
        completed = [t for t in self.trials if t['status'] == 'completed'
                     and metric in t['raw_data']]
        if not completed:
            return np.zeros((0, max(self.space.dim, 1))), np.zeros(0)
        xs = np.array([self.space.to_unit(t['params']) for t in completed])
        vals = np.array([t['raw_data'][metric][0] for t in completed],
                        dtype=np.float64)
        finite = np.isfinite(vals)
        return xs[finite], vals[finite]

    def _feasibility_weight(self, candidates: np.ndarray) -> np.ndarray:
        """Probability that every outcome constraint holds at each
        candidate, from one GP per constrained metric (constrained EI)."""
        from scipy.stats import norm
        from .gp import GaussianProcess
        weight = np.ones(len(candidates))
        for metric, op, bound in self._constraints:
            xs, vals = self._metric_observations(metric)
            if len(xs) < 3:
                continue    # not enough data to model the constraint yet
            gp = GaussianProcess(xs, vals)
            mean, var = gp.posterior(candidates)
            sigma = np.sqrt(np.maximum(var, 1e-12))
            # P(metric <= bound); for >= flip the tail
            p_le = norm.cdf((bound - mean) / sigma)
            weight = weight * (p_le if op == '<=' else 1.0 - p_le)
        return weight

    def _is_feasible(self, raw_data: dict) -> bool:
        """Observed means satisfy every outcome constraint."""
        for metric, op, bound in self._constraints:
            if metric not in raw_data:
                continue
            v = raw_data[metric][0]
            if not np.isfinite(v):
                return False
            if op == '<=' and v > bound:
                return False
            if op == '>=' and v < bound:
                return False
        return True

    def _suggest_gp(self, trial_index: int) -> np.ndarray:
        from .gp import GaussianProcess
        xs, y, feasible = self._scalarized_targets(trial_index)
        if len(xs) < 3:
            return self._sobol_points(1, skip=trial_index)[0]
        gp = GaussianProcess(xs, y)
        # constrained EI: the incumbent is the best *feasible* observation;
        # with none observed yet, use the worst value so EI stays
        # exploratory and the feasibility weight drives the search
        if self._constraints:
            best_y = float(y[feasible].min()) if feasible.any() \
                else float(y.max())
        else:
            best_y = None
        candidates = self._sobol_points(2048, seed_offset=1 + trial_index)
        # densify near the incumbent
        inc_pool_y = np.where(feasible, y, np.inf) if self._constraints else y
        best = xs[int(np.argmin(inc_pool_y))] if np.isfinite(inc_pool_y).any() \
            else xs[int(np.argmin(y))]
        rng = np.random.default_rng(self.seed * 104729 + trial_index)
        local = np.clip(best + rng.normal(scale=0.05, size=(256, xs.shape[1])),
                        0, 1)
        candidates = np.concatenate([candidates, local])
        ei = gp.expected_improvement(candidates, best_y=best_y)
        if self._constraints:
            ei = ei * self._feasibility_weight(candidates)
        return candidates[int(np.argmax(ei))]

    def complete_trial(self, trial_index: int, raw_data: dict):
        trial = self.trials[trial_index]
        norm = {}
        for k, v in raw_data.items():
            if isinstance(v, (tuple, list)):
                norm[k] = [float(v[0]), float(v[1])]
            else:
                norm[k] = [float(v), 0.0]
        trial['raw_data'] = norm
        trial['status'] = 'completed'

    def log_trial_failure(self, trial_index: int):
        self.trials[trial_index]['status'] = 'failed'

    # ---------------------------------------------------------------- pareto
    def get_pareto_optimal_parameters(self, use_model_predictions: bool = False):
        """Pareto-optimal completed trials.

        ``use_model_predictions=False`` extracts the front over the raw
        observed objective means; ``True`` fits one GP per objective and
        extracts the front over the posterior means at the observed points
        (a de-noised front — Ax's model-predictions mode), reporting the
        model's mean/variance instead of the raw observations.  Outcome
        constraints filter the front either way.
        """
        completed, names, ys = self._objective_matrix()
        if not completed:
            return {}
        finite = np.all(np.isfinite(ys), axis=1)
        feasible = np.array([self._is_feasible(t['raw_data'])
                             for t in completed])
        keep_rows = finite & feasible
        idxs = np.nonzero(keep_rows)[0]
        if len(idxs) == 0:
            return {}
        ys_f = ys[keep_rows]
        pred_means = pred_vars = None
        if use_model_predictions and len(idxs) >= 3:
            from .gp import GaussianProcess
            xs_all = np.array([self.space.to_unit(completed[i]['params'])
                               for i in idxs])
            pred_means = np.empty_like(ys_f)
            pred_vars = np.empty_like(ys_f)
            for j, n in enumerate(names):
                # ys is sign-flipped to minimisation; model that directly
                gp = GaussianProcess(xs_all, ys_f[:, j])
                m, v = gp.posterior(xs_all)
                pred_means[:, j] = m
                pred_vars[:, j] = v
            mask = _pareto_efficient_min(pred_means)
        else:
            mask = _pareto_efficient_min(ys_f)
        result = {}
        seen_params = set()
        for row, (local_i, keep) in enumerate(zip(idxs, mask)):
            if not keep:
                continue
            t = completed[local_i]
            if pred_means is not None:
                # identical parameterisations share a posterior, so every
                # duplicate arm would tie onto the predicted front — report
                # each configuration once (Ax dedupes by arm the same way)
                sig = tuple(sorted(t['params'].items()))
                if sig in seen_params:
                    continue
                seen_params.add(sig)
            if pred_means is not None:
                sign = np.array([1.0 if self.objectives[n].minimize else -1.0
                                 for n in names])
                means = {n: float(sign[j] * pred_means[row, j])
                         for j, n in enumerate(names)}
                sems = {n: {n: float(pred_vars[row, j])}
                        for j, n in enumerate(names)}
            else:
                means = {n: float(t['raw_data'][n][0]) for n in names}
                sems = {n: {n: float(t['raw_data'][n][1]) ** 2} for n in names}
            result[t['index']] = (dict(t['params']), (means, sems))
        return result

    # -------------------------------------------------------------- storage
    def to_json_dict(self) -> dict:
        return {
            'engine': 'nnueehcs_tpu-bo-v1',
            'seed': self.seed,
            'experiment': {
                'name': self.experiment_name,
                'parameters': self.space.parameters if self.space else [],
                'objectives': {k: {'minimize': v.minimize}
                               for k, v in self.objectives.items()},
                'tracking_metric_names': self.tracking_metric_names,
                'outcome_constraints': self.outcome_constraints,
            },
            'trials': self.trials,
        }

    def save_to_json_file(self, filepath: str):
        with open(filepath, 'w') as f:
            json.dump(self.to_json_dict(), f, indent=1, default=float)

    @classmethod
    def from_json_dict(cls, d: dict) -> 'BOClient':
        client = cls(seed=d.get('seed', 0))
        exp = d.get('experiment') or {}
        if exp.get('parameters'):
            client.create_experiment(
                name=exp.get('name'),
                parameters=exp['parameters'],
                objectives={k: ObjectiveProperties(minimize=v['minimize'])
                            for k, v in exp.get('objectives', {}).items()},
                tracking_metric_names=exp.get('tracking_metric_names'),
                outcome_constraints=exp.get('outcome_constraints'))
        client.trials = d.get('trials', [])
        return client

    @classmethod
    def load_from_json_file(cls, filepath: str) -> 'BOClient':
        with open(filepath) as f:
            return cls.from_json_dict(json.load(f))


def _parse_outcome_constraint(constraint) -> tuple:
    """Parse an Ax-style outcome constraint string ``"metric <= bound"`` /
    ``"metric >= bound"`` into ``(metric, op, bound)``.  Raises ValueError
    on anything else (relative/scaled constraints are not supported) so an
    unsupported constraint cannot be silently ignored."""
    import re as _re
    if isinstance(constraint, (tuple, list)) and len(constraint) == 3:
        metric, op, bound = constraint
        if op in ('<=', '>='):
            return str(metric), op, float(bound)
        raise ValueError(f'Unsupported outcome-constraint op: {op!r}')
    if not isinstance(constraint, str):
        raise ValueError(f'Unsupported outcome constraint: {constraint!r}')
    m = _re.fullmatch(
        r'\s*([A-Za-z_][\w.:-]*)\s*(<=|>=)\s*([-+0-9.eE]+)\s*', constraint)
    if not m:
        raise ValueError(
            f'Cannot parse outcome constraint {constraint!r}; expected '
            f'"metric <= bound" or "metric >= bound" with a numeric bound')
    return m.group(1), m.group(2), float(m.group(3))


def _pareto_efficient_min(costs: np.ndarray) -> np.ndarray:
    """Boolean mask of Pareto-efficient rows (all objectives minimised)."""
    n = costs.shape[0]
    mask = np.ones(n, dtype=bool)
    for i in range(n):
        if not mask[i]:
            continue
        dominates = np.all(costs <= costs[i], axis=1) & \
            np.any(costs < costs[i], axis=1)
        if dominates.any():
            mask[i] = False
    return mask


# Ax-compatible alias
AxClient = BOClient
