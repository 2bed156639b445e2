"""The port's metrics (``nnueehcs_tpu_torch/evaluation.py``,
``classification.py``) against the JAX package's: every metric that the
factories build from the committed configs, on the same UE arrays and on a
committed bundle's UEs served by both packages (the port on the CPU),
within 1e-5; ``BASELINE.md``'s golden edge values; the runtime and memory
metrics held to their schema; and ``eval()`` on every model class."""
import glob
import os

import numpy as np
import pytest
import torch
import yaml

import nnueehcs_tpu.evaluation as jax_eval
from nnueehcs_tpu.training import load_model as jax_load_model
import nnueehcs_tpu_torch.evaluation as port_eval
from nnueehcs_tpu_torch import classification
from nnueehcs_tpu_torch.model_builder import (
    DeltaUQMLPModelBuilder, EnsembleModelBuilder, KDEModelBuilder,
    KNNKDEModelBuilder, MCDropoutModelBuilder, MLPModelBuilder,
    MVEModelBuilder, PAGERModelBuilder)
from nnueehcs_tpu_torch.training import load_model

from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, 'examples', '**', '*.yaml'),
                           recursive=True)) + [
    os.path.join(REPO, 'experiments', 'grid_r4', 'config_mesh_airfoil.yaml'),
    os.path.join(REPO, 'experiments', 'grid_r5', 'config_kde_full_scale.yaml')]
BUNDLE = os.path.join(REPO, 'experiments', 'full_cell', 'artifacts',
                      'minibude_ensemble_gaps', 'pareto_models',
                      'bo_trial_13', 'model.pth')
TOL = 1e-5
TIMED = ('runtime', 'uncertainty_estimating_runtime', 'base_model_throughput',
         'uncertainty_estimating_throughput', 'max_memory_usage')
# every metric name each factory takes, beside the committed configs'
POSTHOC_ALL = [
    {'name': 'wasserstein'}, {'name': 'mean_score'}, {'name': 'max_score'},
    {'name': 'percentile_score', 'percentile': 90},
    {'name': 'auroc'}, {'name': 'calibration'},
    {'name': 'tnr_at_tpr', 'target_tpr': 0.9, 'reversed': True},
    {'name': 'percentile_classification', 'threshold': 0.7,
     'reversed': True},
    {'name': 'runtime', 'trials': 2, 'warmup': 1},
    {'name': 'uncertainty_estimating_runtime', 'trials': 2, 'warmup': 1},
    {'name': 'base_model_throughput', 'trials': 2, 'warmup': 1},
    {'name': 'uncertainty_estimating_throughput', 'trials': 2, 'warmup': 1},
    {'name': 'max_memory_usage'}]
BO_ALL = [
    'wasserstein_distance', 'euclidean_distance', 'jensen_shannon_distance',
    'mean_score', 'max_score', 'auroc', 'calibration',
    {'name': 'percentile_score', 'percentile': 80},
    {'name': 'percentile_classification', 'threshold': 0.9},
    {'name': 'percentile_classification', 'threshold': 0.9,
     'reversed': True},
    {'name': 'tnr_at_tpr', 'target_tpr': 0.95},
    {'name': 'runtime', 'trials': 2, 'warmup': 1},
    {'name': 'uncertainty_estimating_runtime', 'trials': 2, 'warmup': 1},
    {'name': 'uncertainty_estimating_throughput', 'trials': 2, 'warmup': 1}]


def _committed_metric_lists():
    posthoc, bo = [], []
    for path in CONFIGS:
        with open(path) as f:
            cfg = yaml.safe_load(f)
        if 'evaluation' in cfg:
            posthoc.append(cfg['evaluation']['metrics'])
        if 'bo_config' in cfg:
            bo.append(cfg['bo_config']['evaluation_metric'])
    return posthoc, bo


POSTHOC, BO = _committed_metric_lists()
CASES = ([('posthoc', m) for m in POSTHOC + [POSTHOC_ALL]]
         + [('bo', m) for m in BO + [BO_ALL]])


class ScoreModel:
    """Canned scores, the ID ones for the ID inputs and the OOD ones for
    any other; the port's copy answers torch tensors, the JAX one numpy."""

    def __init__(self, id_input, id_scores, ood_scores, preds, torch_out):
        self.id_input = np.asarray(id_input)
        self.id_scores = id_scores
        self.ood_scores = ood_scores
        self.preds = preds
        self.torch_out = torch_out
        self.device = torch.device('cpu')

    def eval(self):
        return self

    def __call__(self, x, return_ue=False):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        n_id = len(self.id_scores)
        if x.shape == self.id_input.shape and np.array_equal(x, self.id_input):
            scores, preds = self.id_scores, self.preds[:n_id]
        elif x.shape[0] == n_id + len(self.ood_scores):
            scores = np.concatenate([self.id_scores, self.ood_scores])
            preds = self.preds
        else:
            scores, preds = self.ood_scores, self.preds[n_id:]
        if self.torch_out:
            scores, preds = torch.from_numpy(scores), torch.from_numpy(preds)
        return (preds, scores) if return_ue else preds


@pytest.fixture(scope='module')
def score_data():
    rng = np.random.default_rng(4)
    n = 120
    id_in = rng.normal(size=(n, 3)).astype(np.float32)
    ood_in = (rng.normal(size=(n, 3)) + 4).astype(np.float32)
    id_scores = rng.gamma(2.0, 0.1, size=(n, 1)).astype(np.float32)
    ood_scores = (rng.gamma(2.0, 0.1, size=(n, 1)) + 0.15).astype(np.float32)
    preds = rng.normal(size=(2 * n, 1)).astype(np.float32)
    id_out = (preds[:n] + id_scores * rng.normal(size=(n, 1))).astype(
        np.float32)
    ood_out = rng.normal(size=(n, 1)).astype(np.float32)
    models = [ScoreModel(id_in, id_scores, ood_scores, preds, t)
              for t in (True, False)]
    return models, (id_in, id_out), (ood_in, ood_out)


def build(dialect, pkg, metrics):
    factory = pkg.get_evaluator if dialect == 'posthoc' \
        else pkg.get_uncertainty_evaluator
    return factory(metrics)


def assert_results_agree(ours, theirs, metrics):
    """Each metric's results within TOL; the timed and memory metrics
    (whose values are measurements) held to their schema."""
    assert len(ours) == len(theirs) == len(metrics)
    for metric, a, b in zip(metrics, ours, theirs):
        name = type(metric).__name__
        timed = isinstance(metric, (jax_eval.RuntimeEvaluation,
                                    jax_eval.MaxMemoryUsageEvaluation))
        assert sorted(a) == sorted(b), name
        for key in a:
            if timed:
                assert np.isfinite(a[key]) and a[key] >= 0, (name, key)
                continue
            got = port_eval.to_numpy(a[key]).astype(np.float64)
            want = np.asarray(b[key], np.float64)
            assert got.shape == want.shape, (name, key)
            assert np.all(np.abs(got - want) <= TOL * np.maximum(
                1.0, np.abs(want))), (name, key, got, want)


@pytest.mark.parametrize('dialect,metrics', CASES,
                         ids=[f'{d}{i}' for i, (d, _) in enumerate(CASES)])
def test_factory_metrics_agree_on_the_same_scores(score_data, dialect,
                                                  metrics):
    (port_model, jax_model), id_data, ood_data = score_data
    ours = build(dialect, port_eval, metrics)
    theirs = build(dialect, jax_eval, metrics)
    assert [type(m).__name__ for m in ours.metrics] == \
        [type(m).__name__ for m in theirs.metrics]
    assert ours.get_training_objectives() == theirs.get_training_objectives()
    assert ours.get_all_metrics() == theirs.get_all_metrics()
    assert_results_agree(
        [m.evaluate(port_model, id_data, ood_data) for m in ours.metrics],
        [m.evaluate(jax_model, id_data, ood_data) for m in theirs.metrics],
        theirs.metrics)


@pytest.fixture(scope='module')
def bundle_rows():
    rng = np.random.default_rng(9)
    id_in = rng.uniform(0, 1, size=(600, 6)).astype(np.float32)
    ood_in = rng.uniform(0.8, 1.6, size=(600, 6)).astype(np.float32)
    out = rng.uniform(0, 1, size=(600, 1)).astype(np.float32)
    return (id_in, out), (ood_in, out)


@pytest.mark.parametrize('dialect,metrics', [CASES[0], CASES[-1]],
                         ids=['posthoc', 'bo'])
def test_metrics_agree_on_a_committed_bundle(bundle_rows, dialect, metrics):
    """The committed minibude ensemble bundle, served by each package (the
    port on the CPU), through each package's metrics (those with values:
    the timed ones are held to their schema above)."""
    metrics = [m for m in metrics if (m if isinstance(m, str) else m['name'])
               not in TIMED]
    id_data, ood_data = bundle_rows
    ours_model = load_model(BUNDLE, device='cpu')
    theirs_model = jax_load_model(BUNDLE)
    _, ue_ours = ours_model(id_data[0], return_ue=True)
    _, ue_theirs = theirs_model(id_data[0], return_ue=True)
    gap = np.abs(ue_ours.numpy() - np.asarray(ue_theirs)).max()
    assert gap <= TOL
    ours = build(dialect, port_eval, metrics)
    theirs = build(dialect, jax_eval, metrics)
    assert_results_agree(
        [m.evaluate(ours_model, id_data, ood_data) for m in ours.metrics],
        [m.evaluate(theirs_model, id_data, ood_data) for m in theirs.metrics],
        theirs.metrics)


# ------------------------------------------------- BASELINE.md golden values
@pytest.fixture
def separated():
    rng = np.random.default_rng(1)
    id_in = rng.normal(size=(100, 3))
    model = ScoreModel(id_in, rng.uniform(0, 1, 100),
                       rng.uniform(10, 11, 100), np.zeros((200, 1)), True)
    return model, (id_in, np.zeros((100, 1))), \
        (rng.normal(size=(100, 3)) + 50, np.zeros((100, 1)))


def overlapping(scores):
    rng = np.random.default_rng(2)
    id_in = rng.normal(size=(100, 3))
    model = ScoreModel(id_in, scores, scores, np.zeros((200, 1)), True)
    return model, (id_in, None), (rng.normal(size=(100, 3)) + 9, None)


def test_tnr_golden_edges(separated):
    model, id_data, ood_data = separated
    assert port_eval.TNRatTPX(0.95).evaluate(
        model, id_data, ood_data)['tnr_at_tpr95'] == 1.0
    model, id_data, ood_data = overlapping(np.ones(100))
    assert port_eval.TNRatTPX(0.95).evaluate(
        model, id_data, ood_data)['tnr_at_tpr95'] == 0.0
    model, id_data, ood_data = overlapping(np.arange(100.0))
    got = port_eval.TNRatTPX(0.95).evaluate(model, id_data, ood_data)
    assert got['tnr_at_tpr95'] <= 0.06


def test_percentile_classifier_golden_edges(separated):
    model, id_data, ood_data = separated
    res = port_eval.PercentileBasedClassifier(0.95).evaluate(
        model, id_data, ood_data)
    assert res['sensitivity'] == 1.0
    assert res['specificity'] == pytest.approx(0.95)
    model, id_data, ood_data = overlapping(np.arange(100.0))
    res = port_eval.PercentileBasedClassifier(0.95).evaluate(
        model, id_data, ood_data)
    assert res['sensitivity'] == pytest.approx(0.05)
    # the classifier module itself, on tensors, and its all-equal edge case
    clf = classification.PercentileBasedIdOodClassifier(0.9)
    res = clf._evaluate_scores(torch.ones(10), torch.full((10,), 2.0))
    assert res['sensitivity'] == 1.0 and res['specificity'] == 1.0


# ----------------------------------------------------------- UE container
def test_ue_container_takes_tensors_and_refuses_empty_data():
    ue = port_eval.UncertaintyEstimate(torch.ones(5, 1))
    assert isinstance(ue.data, np.ndarray) and ue.mean() == 1.0
    ue = port_eval.UncertaintyEstimate((torch.ones(4), np.zeros(4)))
    assert ue.dimensions == 2 and ue.mean() == 0.5
    for empty in (torch.ones(0), np.array([]), (np.ones(3), torch.ones(0))):
        with pytest.raises(ValueError):
            port_eval.UncertaintyEstimate(empty)
    with pytest.raises(ValueError):
        port_eval.UncertaintyEstimate((np.ones(3), np.ones(4)))
    with pytest.raises(TypeError):
        port_eval.UncertaintyEstimate('not an array')


def test_metric_math_matches_jax():
    rng = np.random.default_rng(5)
    u, v = rng.normal(size=300), rng.normal(0.4, 1.3, size=200)
    assert port_eval.wasserstein_1d(u, v) == jax_eval.wasserstein_1d(u, v)
    p, q = rng.uniform(size=50), rng.uniform(size=50)
    assert port_eval.jensen_shannon_distance(p, q) == \
        jax_eval.jensen_shannon_distance(p, q)
    grid = np.linspace(-3, 3, 101)
    assert np.array_equal(port_eval.gaussian_kde_pdf_1d(u, grid),
                          jax_eval.gaussian_kde_pdf_1d(u, grid))
    y = rng.integers(0, 2, size=80)
    s = np.round(rng.normal(size=80), 1)              # ties
    assert port_eval.auroc_score(y, s) == jax_eval.auroc_score(y, s)


# --------------------------------------------------------- model.eval()
DESCR = [{'Linear': {'args': [5, 16]}}, {'BatchNorm1d': {'args': [16]}},
         {'ReLU': {}}, {'Linear': {'args': [16, 16]}}, {'ReLU': {}},
         {'Linear': {'args': [16, 1]}}]
BUILDERS = {
    'mlp': lambda: MLPModelBuilder(DESCR, device='cpu'),
    'ensemble': lambda: EnsembleModelBuilder(DESCR, {'num_models': 3},
                                             device='cpu'),
    'mc_dropout': lambda: MCDropoutModelBuilder(
        DESCR, {'num_samples': 4, 'dropout_percent': 0.2}, device='cpu'),
    'delta_uq': lambda: DeltaUQMLPModelBuilder(DESCR, {'num_anchors': 4},
                                               device='cpu'),
    'pager': lambda: PAGERModelBuilder(DESCR, {'num_anchors': 4},
                                       device='cpu'),
    'kde': lambda: KDEModelBuilder(DESCR, {'rtol': 1000}, device='cpu'),
    'knn_kde': lambda: KNNKDEModelBuilder(DESCR, {'k': 5}, device='cpu'),
    'mve': lambda: MVEModelBuilder(DESCR, {'min_variance': 1e-7},
                                   device='cpu'),
}


@pytest.mark.parametrize('method', sorted(BUILDERS))
def test_eval_is_a_no_op_on_every_model_class(method):
    """Two models built alike answer alike, one after ``eval()`` (MC
    dropout's first call of each has the same seed)."""
    x = np.random.default_rng(6).normal(size=(40, 5)).astype(np.float32)
    answers = []
    for call_eval in (False, True):
        model = BUILDERS[method]().build()
        rng = np.random.default_rng(7)
        if method in ('delta_uq', 'pager'):
            model.anchors = rng.normal(size=(4, 5))
            if method == 'pager':
                model.anchors_Y = rng.normal(size=(4, 1))
        if method in ('kde', 'knn_kde'):
            model.fit_kde(rng.normal(size=(64, 5)))
        if call_eval:
            assert model.eval() is model
            assert not model.net.training
        out = model(x, return_ue=method != 'mlp')
        answers.append(out if isinstance(out, tuple) else (out,))
    for a, b in zip(*answers):
        assert torch.equal(a, b)
