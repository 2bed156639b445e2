"""The port's results-tree readers (``nnueehcs_tpu_torch/utility.py``)
against the JAX package's, on a tree the port's ``OutputManager`` wrote:
the same names, counts, files, metrics and latest finished trial."""
import os

import numpy as np
import pytest

from nnueehcs_tpu import utility as jax_utility
from nnueehcs_tpu_torch import utility
from nnueehcs_tpu_torch.bo import AxClient, ObjectiveProperties
from nnueehcs_tpu_torch.driver import OutputManager

CELLS = [('minibude', 'tails', 'ensemble', 3),
         ('minibude', 'gaps', 'ensemble', 2),
         ('minibude', 'tails', 'mc_dropout', 1),
         ('airfoil', 'tails', 'kde', 2)]


def row(trial, rng):
    return {'num_models': int(rng.integers(2, 32)), 'learning_rate': 5e-5,
            'batch_size': 128, 'percentile_score': float(rng.uniform()),
            'uncertainty_estimating_throughput': float(rng.uniform(1e6, 1e7)),
            'id_ue': np.float32(rng.uniform()), 'failed': False,
            'error_message': '', 'log_path': f'x/bo_trial_{trial}'}


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp('results')
    rng = np.random.default_rng(0)
    for bench, split, method, trials in CELLS:
        rows = {}
        client = AxClient()
        client.create_experiment('t', [{'name': 'num_models', 'type': 'range',
                                        'bounds': [2, 32]}],
                                 {'m': ObjectiveProperties(True)})
        for trial in range(trials):
            manager = OutputManager(
                str(root / bench / split / method / f'bo_trial_{trial}'),
                bench, append_benchmark_name=False)
            rows[trial] = row(trial, rng)
            manager.save_trial_results_dict(rows)
            manager.save_optimization_state(trial, client)
        # an unfinished trial directory: no results yet
        (root / bench / split / method / f'bo_trial_{trials}').mkdir()
    return str(root)


def test_composite_names_and_counts_match_jax(tree):
    ours, theirs = utility.ResultsComposite(tree), \
        jax_utility.ResultsComposite(tree)
    assert sorted(ours.get_benchmark_names()) == \
        sorted(theirs.get_benchmark_names())
    for bench in theirs.get_benchmark_names():
        assert list(ours.get_dataset_names(bench)) == \
            list(theirs.get_dataset_names(bench))
        assert ours.get_num_datasets(bench) == theirs.get_num_datasets(bench)
        for split in theirs.get_dataset_names(bench):
            assert list(ours.get_method_names(bench, split)) == \
                list(theirs.get_method_names(bench, split))
            for method in theirs.get_method_names(bench, split):
                assert list(ours.get_trial_names(bench, split, method)) == \
                    list(theirs.get_trial_names(bench, split, method))
                assert ours.get_num_trials(bench, split, method) == \
                    theirs.get_num_trials(bench, split, method)
    assert ours.get_num_benchmarks() == theirs.get_num_benchmarks()


def assert_column(got, want):
    """A column read by ``csv`` against pandas': numbers within 1e-13
    relative (pandas' default float parser keeps about 15 significant
    digits of a 17-digit repr; Python's ``float`` is exact), anything else
    equal."""
    want = list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, (float, np.floating)) and not isinstance(g, bool):
            assert (np.isnan(g) and np.isnan(w)) or \
                abs(g - w) <= 1e-13 * abs(w), (g, w)
        else:
            assert g == w, (g, w)


def test_instances_files_and_metrics_match_jax(tree):
    ours, theirs = utility.ResultsComposite(tree), \
        jax_utility.ResultsComposite(tree)
    a, b = list(ours.get_results()), list(theirs.get_results())
    assert [str(x) for x in a] == [str(x) for x in b]
    for x, y in zip(a, b):
        assert x.files == y.files
        assert (x.get_benchmark_name(), x.get_dataset_name(),
                x.get_method_name(), x.get_trial_name(),
                x.get_trial_number()) == \
            (y.get_benchmark_name(), y.get_dataset_name(),
             y.get_method_name(), y.get_trial_name(), y.get_trial_number())
        assert x.is_finished() == y.is_finished()
    finished = {k: v for k, v in theirs.filter(lambda r: r.is_finished()).items()}
    assert sorted(ours.filter(lambda r: r.is_finished())) == sorted(finished)
    for key, inst in finished.items():
        mine = ours.get_results_instance(*key)
        got, want = mine.get_results(), inst.get_results()
        assert got.columns == list(want.columns)
        assert len(got) == len(want)
        for column in want.columns:
            assert_column(got[column], want[column])
        assert_column(mine.get_metric('percentile_score'),
                      inst.get_metric('percentile_score'))
    assert sorted(ours.filter_by_method('kde')) == \
        sorted(theirs.filter_by_method('kde'))


def test_latest_finished_trial_matches_jax(tree, tmp_path):
    for bench, split, method, trials in CELLS:
        method_dir = os.path.join(tree, bench, split, method)
        assert utility.find_latest_finished_trial(method_dir) == \
            jax_utility.find_latest_finished_trial(method_dir)
        assert utility.find_latest_finished_trial(method_dir)[0] == trials - 1
    assert utility.find_latest_finished_trial(tmp_path / 'none') == \
        (None, None)
