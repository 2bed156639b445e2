"""Evaluation metrics, the UE container and the metric factories.

Counterpart of ``nnueehcs_tpu/evaluation.py``, with the same metric math in
numpy:

- 1-Wasserstein via the CDF-difference integral (scipy-equivalent),
- Jensen-Shannon over Gaussian-KDE PDFs on a 20k-point common grid
  (scipy ``gaussian_kde`` semantics: Scott factor x data std),
- AUROC via tie-aware rank statistics (Mann-Whitney U, sklearn-equivalent),
- TNR@TPR as a vectorised threshold sweep,
- runtime and throughput timed by :func:`~nnueehcs_tpu_torch.utils.timing.timed_passes`
  (each pass synchronised with the card), on inputs placed on the model's
  device once,
- peak device memory of one UE pass from ``torch.cuda``'s allocator
  statistics (the JAX package reads XLA's static buffer assignment, which
  has no counterpart here); process RSS for a model on the CPU.

A model's answers may be torch tensors on any device; the metrics turn
them into numpy arrays. Both config dialects are kept: ``get_evaluator``
(the post-hoc metric list) and ``get_uncertainty_evaluator`` (BO time; a
str, dict or list).
"""
from __future__ import annotations

import gc
from abc import ABC, abstractmethod
from typing import Callable

import numpy as np
import torch


def to_numpy(data):
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(data, torch.Tensor):
        return data.detach().cpu().numpy()
    return np.asarray(data)


class MetricError(ValueError):
    """A metric refuses the UEs it was given (empty, of mismatched
    dimensions, one class only): the trial's fault, not the device's."""


# ---------------------------------------------------------------------------
# UE container
# ---------------------------------------------------------------------------
class UncertaintyEstimate:
    """Normalises model scores (numpy, torch on any device, or a tuple of
    them) to numpy.

    A tuple means a multi-dimensional UE (e.g. a method returning several
    score channels); tuple entries must agree on the first dimension.
    """

    def __init__(self, data):
        self.data = self._to_numpy(data)
        if isinstance(self.data, tuple):
            if any(d.size == 0 for d in self.data):
                raise MetricError(
                    'Cannot create UncertaintyEstimate from empty tuple data')
            shapes = [d.shape[0] for d in self.data]
            if len(set(shapes)) > 1:
                raise MetricError(
                    f'All arrays in tuple must have same first dimension, '
                    f'got shapes: {shapes}')
        elif self.data.size == 0:
            raise MetricError('Cannot create UncertaintyEstimate from empty data')

    @property
    def dimensions(self) -> int:
        return len(self.data) if isinstance(self.data, tuple) else 1

    def flatten(self):
        if self.dimensions != 1:
            raise MetricError('Can only flatten 1D uncertainty estimates')
        return self.data.flatten()

    def mean(self):
        return np.mean(self._combine())

    def _combine(self):
        if self.dimensions == 1:
            return self.data
        try:
            return np.concatenate([d.flatten() for d in self.data])
        except ValueError as e:
            raise MetricError(f'Failed to combine data dimensions: {e}')

    def _to_numpy(self, data):
        if isinstance(data, tuple):
            return tuple(self._to_numpy(d) for d in data)
        if isinstance(data, torch.Tensor) or hasattr(data, '__array__'):
            return to_numpy(data)
        raise TypeError(f'Unsupported data type: {type(data)}')


# ---------------------------------------------------------------------------
# native metric math
# ---------------------------------------------------------------------------
def wasserstein_1d(u, v):
    """Equal-weight 1-Wasserstein distance, scipy-equivalent
    (CDF-difference integral over the merged sample grid)."""
    u = np.sort(np.asarray(u, np.float64).ravel())
    v = np.sort(np.asarray(v, np.float64).ravel())
    all_values = np.sort(np.concatenate([u, v]), kind='mergesort')
    deltas = np.diff(all_values)
    u_cdf = np.searchsorted(u, all_values[:-1], side='right') / u.size
    v_cdf = np.searchsorted(v, all_values[:-1], side='right') / v.size
    return float(np.sum(np.abs(u_cdf - v_cdf) * deltas))


def _kl(p, q):
    mask = p > 0
    with np.errstate(divide='ignore'):
        return float(np.sum(p[mask] * np.log(p[mask] / q[mask])))


def jensen_shannon_distance(p, q):
    """JS *distance* (sqrt of divergence, natural log) of two non-negative
    vectors, normalised to probability distributions — scipy
    ``jensenshannon`` semantics."""
    p = np.asarray(p, np.float64).ravel()
    q = np.asarray(q, np.float64).ravel()
    p = p / p.sum()
    q = q / q.sum()
    m = 0.5 * (p + q)
    js = 0.5 * _kl(p, m) + 0.5 * _kl(q, m)
    return float(np.sqrt(max(js, 0.0)))


def gaussian_kde_pdf_1d(samples, grid):
    """scipy.stats.gaussian_kde semantics for 1-D data: Gaussian kernel with
    bandwidth = scott_factor × data std (ddof=1)."""
    samples = np.asarray(samples, np.float64).ravel()
    n = samples.size
    factor = n ** (-1.0 / 5.0)                    # scott, d=1
    sigma = samples.std(ddof=1)
    h = factor * sigma
    if h == 0:
        h = 1e-12
    grid = np.asarray(grid, np.float64)
    # evaluate in chunks to bound the n×g matrix
    out = np.empty_like(grid)
    chunk = max(1, int(5e7 // max(n, 1)))
    norm = 1.0 / (n * h * np.sqrt(2 * np.pi))
    for lo in range(0, grid.size, chunk):
        g = grid[lo:lo + chunk]
        z = (g[None, :] - samples[:, None]) / h
        out[lo:lo + chunk] = norm * np.exp(-0.5 * z * z).sum(axis=0)
    return out


def auroc_score(y_true, y_score):
    """Tie-aware AUROC via average ranks (equivalent to sklearn)."""
    y_true = np.asarray(y_true).ravel()
    y_score = np.asarray(y_score, np.float64).ravel()
    order = np.argsort(y_score, kind='mergesort')
    sorted_scores = y_score[order]
    ranks = np.empty(y_score.size, np.float64)
    # average ranks over ties
    i = 0
    r = 1.0
    while i < sorted_scores.size:
        j = i
        while j + 1 < sorted_scores.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        avg = (r + r + (j - i)) / 2.0
        ranks[order[i:j + 1]] = avg
        r += j - i + 1
        i = j + 1
    n_pos = int(y_true.sum())
    n_neg = y_true.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise MetricError('AUROC requires both classes present')
    rank_sum = ranks[y_true == 1].sum()
    u = rank_sum - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


# ---------------------------------------------------------------------------
# metric ABCs
# ---------------------------------------------------------------------------
class EvaluationMetric(ABC):
    """Base class for all evaluation metrics."""

    @abstractmethod
    def evaluate(self, model, id_data: tuple, ood_data: tuple) -> dict:
        pass

    @classmethod
    @abstractmethod
    def get_objectives(cls):
        pass

    @classmethod
    @abstractmethod
    def get_metrics(cls):
        pass

    @abstractmethod
    def get_name(cls):
        pass


class UncertaintyEvaluationMetric(EvaluationMetric):
    def evaluate(self, model, id_data: tuple, ood_data: tuple) -> dict:
        model.eval()
        _, id_scores = model(id_data[0], return_ue=True)
        _, ood_scores = model(ood_data[0], return_ue=True)

        id_ue = UncertaintyEstimate(id_scores)
        ood_ue = UncertaintyEstimate(ood_scores)
        result = self._evaluate_uncertainties(id_ue, ood_ue)
        return {k: float(v) for k, v in result.items()}

    def _evaluate_uncertainties(self, id_ue, ood_ue) -> dict:
        raise NotImplementedError


class ClassificationMetric(EvaluationMetric):
    def evaluate(self, model, id_data: tuple, ood_data: tuple) -> dict:
        _, id_scores = model(id_data[0], return_ue=True)
        _, ood_scores = model(ood_data[0], return_ue=True)
        return self._evaluate_scores(to_numpy(id_scores), to_numpy(ood_scores))

    @abstractmethod
    def _evaluate_scores(self, id_scores, ood_scores) -> dict:
        pass


# ---------------------------------------------------------------------------
# distance metrics
# ---------------------------------------------------------------------------
class WassersteinEvaluation(UncertaintyEvaluationMetric):
    name = 'wasserstein_distance'

    def _evaluate_uncertainties(self, id_ue, ood_ue) -> dict:
        if id_ue.dimensions != ood_ue.dimensions:
            raise MetricError('Uncertainty estimates must have the same dimensions')
        if id_ue.dimensions == 1:
            value = wasserstein_1d(id_ue.flatten(), ood_ue.flatten())
        else:
            value = np.mean([wasserstein_1d(id_ue.data[i].flatten(),
                                            ood_ue.data[i].flatten())
                             for i in range(id_ue.dimensions)])
        return {self.name: value}

    @classmethod
    def get_objectives(cls):
        return [{'name': cls.name, 'type': 'maximize'}]

    @classmethod
    def get_metrics(cls):
        return [cls.name]

    def get_name(self):
        return self.name


class EuclideanEvaluation(UncertaintyEvaluationMetric):
    name = 'euclidean_distance'

    def _evaluate_uncertainties(self, id_ue, ood_ue) -> dict:
        if id_ue.dimensions != ood_ue.dimensions:
            raise MetricError('Uncertainty estimates must have the same dimensions')
        result = np.mean(np.sqrt(np.sum(
            (np.asarray(id_ue.data) - np.asarray(ood_ue.data)) ** 2, axis=-1)))
        return {self.name: float(result)}

    @classmethod
    def get_objectives(cls):
        return [{'name': cls.name, 'type': 'maximize'}]

    @classmethod
    def get_metrics(cls):
        return [cls.name]

    def get_name(self):
        return self.name


class JensenShannonEvaluation(UncertaintyEvaluationMetric):
    name = 'jensen_shannon_distance'

    def _evaluate_uncertainties(self, id_ue, ood_ue) -> dict:
        if id_ue.dimensions != ood_ue.dimensions:
            raise MetricError('Uncertainty estimates must have the same dimensions')
        return {self.name: self._average_js_distance(id_ue.data, ood_ue.data)}

    def _average_js_distance(self, p1, p2) -> float:
        if p1.ndim == 1 or (p1.ndim == 2 and p1.shape[1] == 1):
            return self.pdf_jsd(p1.flatten(), p2.flatten())
        return float(np.mean([jensen_shannon_distance(p1[i], p2[i])
                              for i in range(p1.shape[0])]))

    def pdf_jsd(self, dist1, dist2, num_points: int = 20000) -> float:
        x_range = np.linspace(min(dist1.min(), dist2.min()),
                              max(dist1.max(), dist2.max()), num_points)
        pdf1 = gaussian_kde_pdf_1d(dist1, x_range)
        pdf2 = gaussian_kde_pdf_1d(dist2, x_range)
        return jensen_shannon_distance(pdf1, pdf2)

    @classmethod
    def get_objectives(cls):
        return [{'name': cls.name, 'type': 'maximize'}]

    @classmethod
    def get_metrics(cls):
        return [cls.name]

    def get_name(self):
        return self.name


# ---------------------------------------------------------------------------
# score-statistic metrics
# ---------------------------------------------------------------------------
class MeanScoreEvaluation(UncertaintyEvaluationMetric):
    """Mean ID score — a minimisation proxy needing no OOD data at tune
    time."""
    name = 'mean_score'

    def _evaluate_uncertainties(self, id_ue, ood_ue) -> dict:
        if id_ue.dimensions != ood_ue.dimensions:
            raise MetricError('Uncertainty estimates must have the same dimensions')
        return {self.name: np.mean(id_ue.data)}

    @classmethod
    def get_objectives(cls):
        return [{'name': cls.name, 'type': 'minimize'}]

    @classmethod
    def get_metrics(cls):
        return [cls.name]

    def get_name(self):
        return self.name


class MaxScoreEvaluation(UncertaintyEvaluationMetric):
    name = 'max_score'

    def _evaluate_uncertainties(self, id_ue, ood_ue) -> dict:
        return {self.name: np.max(id_ue.data)}

    @classmethod
    def get_objectives(cls):
        return [{'name': cls.name, 'type': 'maximize'}]

    @classmethod
    def get_metrics(cls):
        return [cls.name]

    def get_name(self):
        return self.name


class PercentileScoreEvaluation(UncertaintyEvaluationMetric):
    name = 'percentile_score'

    def __init__(self, percentile: float = 95.0):
        if not 0 <= percentile <= 100:
            raise ValueError(
                f'percentile must be between 0 and 100, got {percentile}')
        self.percentile = percentile

    @classmethod
    def from_config(cls, config: dict):
        return cls(percentile=config.get('percentile', 95.0))

    def _evaluate_uncertainties(self, id_ue, ood_ue) -> dict:
        if id_ue.dimensions != ood_ue.dimensions:
            raise MetricError('Uncertainty estimates must have the same dimensions')
        return {self.name: np.percentile(id_ue.data, self.percentile)}

    @classmethod
    def get_objectives(cls):
        return [{'name': cls.name, 'type': 'minimize'}]

    @classmethod
    def get_metrics(cls):
        return [cls.name]

    def get_name(self):
        return self.name


# ---------------------------------------------------------------------------
# cost metrics
# ---------------------------------------------------------------------------
class MaxMemoryUsageEvaluation(EvaluationMetric):
    """Device memory (MB) that one UE pass at the combined batch takes.

    On the card: the allocator's peak during one pass over the combined ID
    and OOD inputs (copied from the host inside the pass), less what was
    allocated before it (``torch.cuda.reset_peak_memory_stats``, then
    ``max_memory_allocated`` after the synchronised pass), as the
    reference's CUDA peak-statistics delta. The JAX package reads XLA's
    static buffer assignment of the pass instead
    (``eval_pass_memory_mb``), which has no counterpart here. For a model
    on the CPU: the process's peak resident set size.
    """

    name = 'max_memory_usage'

    def evaluate(self, model, id_data: tuple, ood_data: tuple) -> dict:
        from .utils.timing import device_sync
        model.eval()
        combined = np.concatenate([to_numpy(id_data[0]), to_numpy(ood_data[0])])
        device = model.device
        if device.type != 'cuda':
            import resource
            device_sync(model(combined, return_ue=True))
            mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
            return {'max_memory_usage': float(mb)}
        gc.collect()
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
        out = device_sync(model(combined, return_ue=True))
        peak = torch.cuda.max_memory_allocated(device)
        del out
        return {'max_memory_usage': float((peak - before) / (1024 * 1024))}

    @classmethod
    def get_objectives(cls):
        return [{'name': cls.name, 'type': 'minimize'}]

    @classmethod
    def get_metrics(cls):
        return [cls.name]

    def get_name(self):
        return self.name


class RuntimeEvaluation(EvaluationMetric):
    name = 'runtime'

    def __init__(self, num_trials: int = 20, num_warmup: int = 5):
        self.num_trials = num_trials
        self.num_warmup = num_warmup

    @classmethod
    def from_config(cls, config: dict):
        return cls(num_trials=config.get('trials', 20),
                   num_warmup=config.get('warmup', 5))

    def evaluate(self, model, id_data: tuple, ood_data: tuple) -> dict:
        raise NotImplementedError('Cannot call evaluate on base class')

    def _evaluate(self, model, id_data, ood_data, eval_functor: Callable,
                  return_raw: bool = False) -> dict:
        from .utils.timing import timed_passes
        model.eval()
        # on the model's device once, like the reference's pre-timing
        # ``.to(model.device)``: otherwise every timed pass would re-pay
        # the host-to-device copy
        data_combined = torch.as_tensor(np.concatenate(
            [to_numpy(id_data[0]), to_numpy(ood_data[0])]),
            device=model.device)
        runtimes = timed_passes(lambda: eval_functor(model, data_combined),
                                self.num_warmup, self.num_trials)
        result = {'runtime': float(np.mean(runtimes)),
                  'runtime_std': float(np.std(runtimes))}
        if return_raw:
            result['runtimes'] = runtimes
        return result

    @classmethod
    def get_objectives(cls):
        return [{'name': cls.name, 'type': 'minimize'}]

    @classmethod
    def get_metrics(cls):
        return [cls.name, 'runtime_std']

    def get_name(self):
        return self.name


class BaseModelRuntimeEvaluation(RuntimeEvaluation):
    name = 'base_model_runtime'

    def evaluate(self, model, id_data, ood_data) -> dict:
        return super()._evaluate(model, id_data, ood_data,
                                 lambda m, d: m(d))


class UncertaintyEstimatingRuntimeEvaluation(RuntimeEvaluation):
    name = 'uncertainty_estimating_runtime'

    def evaluate(self, model, id_data, ood_data) -> dict:
        return super()._evaluate(model, id_data, ood_data,
                                 lambda m, d: m(d, return_ue=True))


class BaseModelThroughputEvaluation(RuntimeEvaluation):
    name = 'base_model_throughput'

    def _convert_to_throughput(self, runtimes: dict, total_samples: int):
        throughput = total_samples / runtimes['runtimes']
        return float(np.mean(throughput)), float(np.std(throughput))

    def evaluate(self, model, id_data, ood_data) -> dict:
        runtimes = super()._evaluate(model, id_data, ood_data,
                                     lambda m, d: m(d), return_raw=True)
        total = len(id_data[0]) + len(ood_data[0])
        mean, std = self._convert_to_throughput(runtimes, total)
        return {self.name: mean, 'throughput_std': std}

    @classmethod
    def get_objectives(cls):
        return [{'name': cls.name, 'type': 'maximize'}]

    @classmethod
    def get_metrics(cls):
        return [cls.name]


class UncertaintyEstimatingThroughputEvaluation(BaseModelThroughputEvaluation):
    name = 'uncertainty_estimating_throughput'

    def evaluate(self, model, id_data, ood_data) -> dict:
        runtimes = super()._evaluate(model, id_data, ood_data,
                                     lambda m, d: m(d, return_ue=True),
                                     return_raw=True)
        total = len(id_data[0]) + len(ood_data[0])
        mean, std = self._convert_to_throughput(runtimes, total)
        return {self.name: mean, 'throughput_std': std}

    @classmethod
    def get_objectives(cls):
        return [{'name': cls.name, 'type': 'maximize'}]

    @classmethod
    def get_metrics(cls):
        return [cls.name]

    @classmethod
    def get_name(cls):
        return cls.name


# ---------------------------------------------------------------------------
# discrimination metrics
# ---------------------------------------------------------------------------
class TNRatTPX(ClassificationMetric):
    """TNR at a target TPR — vectorised threshold sweep."""

    def __init__(self, target_tpr: float, reversed: bool = False):
        if not 0 <= target_tpr <= 1:
            raise ValueError(
                f'target_tpr must be between 0 and 1, got {target_tpr}')
        self.target_tpr = target_tpr
        self.metric_name = 'tnr_at_tpr'
        self.reversed = reversed

    @classmethod
    def from_config(cls, config: dict):
        return cls(target_tpr=config['target_tpr'],
                   reversed=config.get('reversed', False))

    def _evaluate_scores(self, id_scores, ood_scores) -> dict:
        id_scores = to_numpy(id_scores).reshape(-1)
        ood_scores = to_numpy(ood_scores).reshape(-1)

        if self.reversed:
            if id_scores.min() > ood_scores.max():
                return {str(self): 1.0}
        else:
            if id_scores.max() < ood_scores.min():
                return {str(self): 1.0}

        thresholds = np.unique(np.concatenate([id_scores, ood_scores]))
        id_sorted = np.sort(id_scores)
        ood_sorted = np.sort(ood_scores)
        n_id, n_ood = id_sorted.size, ood_sorted.size

        # counts of scores strictly above / at-or-below each threshold
        id_le = np.searchsorted(id_sorted, thresholds, side='right')
        ood_le = np.searchsorted(ood_sorted, thresholds, side='right')
        if self.reversed:
            tp = n_id - id_le          # id > threshold
            tn = ood_le                # ood <= threshold
            tpr = tp / n_ood if n_ood > 0 else np.zeros_like(tp, float)
            tnr = tn / n_id if n_id > 0 else np.zeros_like(tn, float)
        else:
            tp = n_ood - ood_le        # ood > threshold
            tn = id_le                 # id <= threshold
            tpr = tp / n_ood if n_ood > 0 else np.zeros_like(tp, float)
            tnr = tn / n_id if n_id > 0 else np.zeros_like(tn, float)

        feasible = tpr >= self.target_tpr
        best_tnr = float(tnr[feasible].max()) if feasible.any() else 0.0
        return {str(self): best_tnr}

    @classmethod
    def get_objectives(cls):
        return [{'name': 'tnr_at_tpr', 'type': 'maximize'}]

    @classmethod
    def get_metrics(cls):
        return ['tnr_at_tpr']

    def get_instance_objectives(self):
        return [{'name': self.metric_name, 'type': 'maximize'}]

    def get_instance_metrics(self):
        return [self.metric_name]

    def get_name(self):
        return f'{self.metric_name}{int(100 * self.target_tpr)}'

    def __str__(self):
        return self.get_name()


class AUROC(ClassificationMetric):
    name = 'auroc'

    def _evaluate_scores(self, id_scores, ood_scores) -> dict:
        id_scores = to_numpy(id_scores).flatten()
        ood_scores = to_numpy(ood_scores).flatten()
        y_scores = np.concatenate([id_scores, ood_scores])
        y_true = np.concatenate([np.zeros_like(id_scores),
                                 np.ones_like(ood_scores)])
        return {self.name: auroc_score(y_true, y_scores)}

    @classmethod
    def get_objectives(cls):
        return [{'name': 'auroc', 'type': 'maximize'}]

    @classmethod
    def get_metrics(cls):
        return ['auroc']

    def get_name(self):
        return self.name


class PercentileBasedClassifier(ClassificationMetric):
    def __init__(self, percentile: float, reversed: bool = False):
        from .classification import PercentileBasedIdOodClassifier
        self._classifier = PercentileBasedIdOodClassifier(percentile)
        self.reversed = reversed

    def _evaluate_scores(self, id_scores, ood_scores) -> dict:
        if self.reversed:
            results = self._classifier._evaluate_scores(
                -to_numpy(id_scores), -to_numpy(ood_scores))
        else:
            results = self._classifier._evaluate_scores(id_scores, ood_scores)
        return {k: v for k, v in results.items() if k in self.get_metrics()}

    @classmethod
    def get_objectives(cls):
        return [{'name': 'sensitivity', 'type': 'maximize'},
                {'name': 'specificity', 'type': 'maximize'}]

    @classmethod
    def get_metrics(cls):
        return ['sensitivity', 'specificity']

    def get_name(self):
        suffix = f'_{int(100 * self._classifier.percentile)}'
        if self.reversed:
            suffix = f'_reversed{suffix}'
        return f'percentile_classification{suffix}'


class CalibrationEvaluation(EvaluationMetric):
    """Regression-calibration of the uncertainty estimate on ID data
    (beyond-reference addition; the harness metadata calls for calibration
    metrics alongside discrimination and cost).

    Treats the UE as a predictive standard deviation: for confidence levels
    ``p`` the empirical coverage of ``|y − pred| ≤ z_p · ue`` is compared to
    ``p``; reported as the mean absolute miscalibration over a grid
    (``calibration_error``, 0 = perfectly calibrated) plus the 68%/95%
    coverages.  Only meaningful for spread-type UEs (ensemble/MC/ΔUQ/MVE);
    density scores yield large errors by construction.
    """
    name = 'calibration_error'
    _LEVELS = np.linspace(0.05, 0.95, 19)

    def evaluate(self, model, id_data: tuple, ood_data: tuple) -> dict:
        model.eval()
        preds, ue = model(id_data[0], return_ue=True)
        preds = to_numpy(preds).astype(np.float64).reshape(-1)
        sigma = np.abs(to_numpy(ue).astype(np.float64).reshape(-1)) + 1e-12
        y = to_numpy(id_data[1]).astype(np.float64).reshape(-1)
        z = np.abs(y - preds) / sigma

        from math import erf, sqrt
        errors = []
        coverages = {}
        for p in self._LEVELS:
            # z_p with Phi(z) - Phi(-z) = p  ⇒ z_p = sqrt(2) erfinv(p)
            z_p = _norm_two_sided_quantile(p)
            cov = float(np.mean(z <= z_p))
            errors.append(abs(cov - p))
            coverages[p] = cov
        cov68 = float(np.mean(z <= 1.0))
        cov95 = float(np.mean(z <= 1.959963984540054))
        return {self.name: float(np.mean(errors)),
                'coverage_68': cov68,
                'coverage_95': cov95}

    @classmethod
    def get_objectives(cls):
        return [{'name': cls.name, 'type': 'minimize'}]

    @classmethod
    def get_metrics(cls):
        return [cls.name, 'coverage_68', 'coverage_95']

    def get_name(self):
        return self.name


def _norm_two_sided_quantile(p: float) -> float:
    """z with P(|Z| <= z) = p for standard normal (scipy-free erfinv via
    bisection — evaluated on a tiny grid, cost is irrelevant)."""
    from math import erf, sqrt
    lo, hi = 0.0, 10.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if erf(mid / sqrt(2.0)) < p:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


# ---------------------------------------------------------------------------
# aggregation + factories
# ---------------------------------------------------------------------------
class MetricEvaluator:
    def __init__(self, metrics):
        self.metrics = metrics

    def evaluate(self, model, id_data: tuple, ood_data: tuple) -> dict:
        results = {}
        for metric in self.metrics:
            results.update(metric.evaluate(model, id_data, ood_data))
        return results

    def get_training_objectives(self):
        objectives = []
        for metric in self.metrics:
            if hasattr(metric, 'get_instance_objectives'):
                objectives.extend(metric.get_instance_objectives())
            else:
                objectives.extend(metric.get_objectives())
        return objectives

    def get_all_metrics(self):
        metrics = []
        for metric in self.metrics:
            if hasattr(metric, 'get_instance_metrics'):
                metrics.extend(metric.get_instance_metrics())
            else:
                metrics.extend(metric.get_metrics())
        return metrics


def get_evaluator(config) -> MetricEvaluator:
    """Post-hoc metric-list dialect."""
    metrics = []
    if not isinstance(config, list):
        config = [config]
    for metric_config in config:
        metric_type = metric_config['name']
        if metric_type == 'wasserstein':
            metrics.append(WassersteinEvaluation())
        elif metric_type == 'percentile_classification':
            is_reversed = metric_config.get('reversed', False)
            metrics.append(PercentileBasedClassifier(
                metric_config['threshold'], is_reversed))
        elif metric_type == 'tnr_at_tpr':
            metrics.append(TNRatTPX.from_config(metric_config))
        elif metric_type == 'runtime':
            metrics.append(BaseModelRuntimeEvaluation.from_config(metric_config))
        elif metric_type == 'uncertainty_estimating_runtime':
            metrics.append(
                UncertaintyEstimatingRuntimeEvaluation.from_config(metric_config))
        elif metric_type == 'mean_score':
            metrics.append(MeanScoreEvaluation())
        elif metric_type == 'max_score':
            metrics.append(MaxScoreEvaluation())
        elif metric_type == 'percentile_score':
            metrics.append(PercentileScoreEvaluation.from_config(metric_config))
        elif metric_type == 'base_model_throughput':
            metrics.append(BaseModelThroughputEvaluation.from_config(metric_config))
        elif metric_type == 'uncertainty_estimating_throughput':
            metrics.append(
                UncertaintyEstimatingThroughputEvaluation.from_config(metric_config))
        elif metric_type == 'auroc':
            metrics.append(AUROC())
        elif metric_type == 'max_memory_usage':
            metrics.append(MaxMemoryUsageEvaluation())
        elif metric_type == 'calibration':
            metrics.append(CalibrationEvaluation())
    return MetricEvaluator(metrics)


def get_uncertainty_evaluator(metric_config) -> MetricEvaluator:
    """BO-time dialect: str | dict | list."""
    metrics = []
    if isinstance(metric_config, list):
        for config in metric_config:
            if isinstance(config, str):
                config = {'name': config}
            metrics.append(_create_single_evaluator(config))
    else:
        if isinstance(metric_config, str):
            metric_config = {'name': metric_config}
        metrics.append(_create_single_evaluator(metric_config))
    return MetricEvaluator(metrics)


def _create_single_evaluator(metric_config: dict) -> EvaluationMetric:
    from .classification import (PercentileBasedIdOodClassifier,
                                 ReversedPercentileBasedIdOodClassifier)

    distance_metrics = {
        WassersteinEvaluation.name: WassersteinEvaluation,
        EuclideanEvaluation.name: EuclideanEvaluation,
        JensenShannonEvaluation.name: JensenShannonEvaluation,
    }

    name = metric_config['name']
    if name in distance_metrics:
        return distance_metrics[name]()

    if name == 'percentile_classification':
        threshold = metric_config['threshold']
        is_reversed = metric_config.get('reversed', False)
        return (ReversedPercentileBasedIdOodClassifier if is_reversed
                else PercentileBasedIdOodClassifier)(threshold)
    elif name == 'tnr_at_tpr':
        return TNRatTPX(metric_config['target_tpr'],
                        metric_config.get('reversed', False))
    elif name == 'runtime':
        kwargs = {}
        if 'trials' in metric_config:
            kwargs['num_trials'] = metric_config['trials']
        if 'warmup' in metric_config:
            kwargs['num_warmup'] = metric_config['warmup']
        return BaseModelRuntimeEvaluation(**kwargs)
    elif name == 'uncertainty_estimating_runtime':
        # the reference built this one without reading the config, so a
        # configured ``trials``/``warmup`` was ignored there; it is honored
        return UncertaintyEstimatingRuntimeEvaluation.from_config(metric_config)
    elif name == 'uncertainty_estimating_throughput':
        return UncertaintyEstimatingThroughputEvaluation.from_config(metric_config)
    elif name == 'mean_score':
        return MeanScoreEvaluation()
    elif name == 'max_score':
        return MaxScoreEvaluation()
    elif name == 'percentile_score':
        return PercentileScoreEvaluation.from_config(metric_config)
    elif name == 'auroc':
        return AUROC()
    elif name == 'calibration':
        return CalibrationEvaluation()
    else:
        raise ValueError(f'Invalid metric type: {name}')
