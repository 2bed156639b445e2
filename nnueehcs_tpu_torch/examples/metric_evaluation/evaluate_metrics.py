"""Post-hoc application of the full metric list to saved BO-trial models
(counterpart of ``examples/metric_evaluation/evaluate_metrics.py``).

Walks the results tree, selects the Pareto-optimal (or all) runs per
(benchmark, dataset, method) using the BO objectives recorded in
``trial_results.csv``, reloads each ``model.pth`` bundle on the device and
re-evaluates ``evaluation.metrics`` from the config; writes a tidy CSV
``[benchmark, dataset, method, trial, metric, objective, value]``::

    python -m nnueehcs_tpu_torch.examples.metric_evaluation.evaluate_metrics \\
        --results_dir results --config_file config.yaml [--device cpu]

A trial whose bundle fails to load, or whose UEs a metric refuses, gets a
``FAILED`` row and the others go on; a kernel that will not build or
launch ends the run. An explicit ``--method`` absent from the tree
evaluates nothing; when nothing was evaluated the command exits non-zero
and writes no file.
"""
from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

from ... import config as config_reader
from ...data_utils import get_dataset, prepare_dataset_for_use
from ...evaluation import MetricError, get_evaluator
from ...models.base import resolve_device
from ...training import load_model
from ...utility import (ResultsComposite, ResultsInstance, ResultsTable,
                        find_latest_finished_trial, missing, write_table)

COLUMNS = ['benchmark', 'dataset', 'method', 'trial', 'metric', 'objective',
           'value']


# what loading a trial's bundle raises when the file is missing, truncated
# or not a bundle
BUNDLE_FAULTS = (OSError, EOFError, pickle.UnpicklingError, ValueError,
                 KeyError, NotImplementedError)


def failed_row(benchmark, dataset, method, trial, error):
    print(f'FAILED {benchmark}/{dataset}/{method}/{trial}: {error}')
    return [benchmark, dataset, method, trial, 'FAILED', 'FAILED',
            str(error)]


def get_evaluators(metrics):
    return [get_evaluator(metric) for metric in metrics]


def get_latest_finished_trial(composite, benchmark, dataset_name, method):
    """Latest trial with results; None when no trial has finished."""
    method_dir = Path(composite.results_dir, benchmark, dataset_name, method)
    _, trial_dir = find_latest_finished_trial(method_dir)
    if trial_dir is None:
        return None
    return composite.get_results_instance(benchmark, dataset_name, method,
                                          trial_dir.name)


def get_benchmark_dataset_pairs(composite, benchmark=None, dataset=None):
    pairs = []
    benchmarks = [benchmark] if benchmark \
        else list(composite.get_benchmark_names())
    for bench in benchmarks:
        datasets = [dataset] if dataset \
            else list(composite.get_dataset_names(bench))
        for ds in datasets:
            if list(composite.get_method_names(bench, ds)):
                pairs.append((bench, ds))
            else:
                print(f'Warning: Skipping {bench}/{ds} - no methods found')
    return pairs


def prepare_datasets(dataset_cfg, dataset_name, training_cfg):
    dataset_id = get_dataset(dataset_cfg, dataset_name)
    dataset_ood = get_dataset(dataset_cfg, dataset_name, is_ood=True)
    dataset_ood = prepare_dataset_for_use(dataset_ood, training_cfg,
                                          scaling_dset=dataset_id)
    dataset_id = prepare_dataset_for_use(dataset_id, training_cfg)
    return dataset_id, dataset_ood


def evaluate_model_metrics(model, dataset_id, dataset_ood, evaluators):
    results = []
    for metric in evaluators.metrics:
        print(f'Evaluating with {metric.get_name()}')
        result = metric.evaluate(model,
                                 (np.asarray(dataset_id.input),
                                  np.asarray(dataset_id.output)),
                                 (np.asarray(dataset_ood.input),
                                  np.asarray(dataset_ood.output)))
        for objective_name, objective_value in result.items():
            results.append([metric.get_name(), objective_name,
                            objective_value])
    return results


def find_all_training_runs(results_instance: ResultsInstance):
    return ResultsTable(results_instance.get_trial_results_file()).records()


def is_pareto_efficient(costs):
    is_efficient = np.ones(costs.shape[0], dtype=bool)
    for i, c in enumerate(costs):
        if is_efficient[i]:
            is_efficient[is_efficient] = (
                np.any(costs[is_efficient] < c, axis=1)
                | np.all(costs[is_efficient] == c, axis=1))
    return is_efficient


def find_pareto_optimal_runs(results_instance: ResultsInstance,
                             train_eval_metrics):
    table = ResultsTable(results_instance.get_trial_results_file())
    rows = table.records()
    # Failed trials are NaN-metric rows; NaN compares False on both sides
    # of the Pareto test, so one such row would mark every row
    # non-efficient: drop them (and any row missing an objective) first.
    # ``== True`` as pandas compares, so a 1.0 counts as failed too.
    if 'failed' in table.columns:
        rows = [r for r in rows if not r['failed'] == True]  # noqa: E712
    for metric in train_eval_metrics:
        name = metric.get_metrics()[0]
        if name in table.columns:
            rows = [r for r in rows if not missing(r[name])]
    if not rows:
        print('Found 0 Pareto-optimal runs out of 0 successful runs')
        return []

    if len(train_eval_metrics) == 1:
        metric = train_eval_metrics[0]
        name = metric.get_metrics()[0]
        pick = max if metric.get_objectives()[0]['type'] == 'maximize' \
            else min
        best = pick(r[name] for r in rows)
        return [r for r in rows if r[name] == best]

    costs = np.zeros((len(rows), len(train_eval_metrics)))
    for i, metric in enumerate(train_eval_metrics):
        name = metric.get_metrics()[0]
        direction = 1 if metric.get_objectives()[0]['type'] == 'maximize' \
            else -1
        costs[:, i] = np.array([r[name] for r in rows],
                               dtype=np.float64) * -direction

    mask = is_pareto_efficient(costs)
    pareto_runs = [r for r, keep in zip(rows, mask) if keep]
    print(f'Found {len(pareto_runs)} Pareto-optimal runs out of '
          f'{len(rows)} total runs')
    return pareto_runs


def process_benchmark_dataset(composite, config, benchmark, dataset,
                              evaluators, method=None, evaluate_all=False,
                              device='cuda'):
    print(f'\nProcessing benchmark {benchmark}, dataset {dataset}')
    dataset_cfg = config['benchmarks'][benchmark]['datasets']
    training_cfg = config['training']
    train_eval_metrics = [
        ev.metrics[0]
        for ev in get_evaluators(config['bo_config']['evaluation_metric'])]
    print(f'Using training evaluation metrics: '
          f'{[m.get_name() for m in train_eval_metrics]}')

    dataset_id, dataset_ood = prepare_datasets(dataset_cfg, dataset,
                                               training_cfg)

    results = []
    all_methods = list(composite.get_method_names(benchmark, dataset))
    if method:
        # an explicit --method that is not in the tree must not fall back
        # to the other methods: the caller names the output file after the
        # requested cell
        if method not in all_methods:
            print(f"ERROR: Method '{method}' not found for "
                  f'{benchmark}/{dataset}. Available methods: {all_methods}')
            return results
        methods = [method]
    else:
        methods = all_methods

    for current_method in methods:
        print(f'\nEvaluating method: {current_method}')
        inst = get_latest_finished_trial(composite, benchmark, dataset,
                                         current_method)
        if inst is None:
            print(f'Warning: no finished trials for {benchmark}/{dataset}/'
                  f'{current_method}; skipping')
            continue
        runs = find_all_training_runs(inst) if evaluate_all \
            else find_pareto_optimal_runs(inst, train_eval_metrics)

        for run in runs:
            trial = Path(run['log_path']).stem
            print(f'Evaluating trial: {trial}')
            # per-trial fault isolation: a trial whose bundle is missing,
            # truncated or not a bundle, or whose UEs a metric refuses
            # (MetricError), gets a FAILED row and the other trials go on.
            # A kernel that will not build or launch (RuntimeError, OSError
            # while its library loads, a wrapper's ValueError) is not the
            # trial's: it ends the run.
            trial_inst = composite.get_results_instance(
                benchmark, dataset, current_method, trial)
            try:
                model = load_model(trial_inst.get_model_file(),
                                   device=device)
            except BUNDLE_FAULTS as e:
                results.append(failed_row(benchmark, dataset, current_method,
                                          trial, e))
                continue
            try:
                metric_results = evaluate_model_metrics(
                    model, dataset_id, dataset_ood, evaluators)
            except MetricError as e:
                results.append(failed_row(benchmark, dataset, current_method,
                                          trial, e))
                continue
            for metric_name, objective_name, value in metric_results:
                results.append([benchmark, dataset, current_method, trial,
                                metric_name, objective_name, value])
    return results


def evaluate_metrics(results_dir, config_file, benchmark=None, dataset=None,
                     method=None, output='evaluated_metrics.csv',
                     evaluate_all=False, device='cuda'):
    """Evaluate the tree and write ``output``; returns the rows. Raises
    ``SystemExit`` (non-zero, no file) when nothing was evaluated."""
    device = resolve_device(device)
    composite = ResultsComposite(results_dir)
    config = config_reader.load_path(config_file)

    evaluators = get_evaluator(config['evaluation']['metrics'])
    pairs = get_benchmark_dataset_pairs(composite, benchmark, dataset)
    if not pairs:
        raise ValueError('No valid benchmark-dataset pairs found to evaluate')

    rows = []
    for current_benchmark, current_dataset in pairs:
        rows.extend(process_benchmark_dataset(
            composite, config, current_benchmark, current_dataset,
            evaluators, method, evaluate_all, device))

    if not rows:
        raise SystemExit(f'no results evaluated; not writing {output}')
    write_table(output, COLUMNS, rows)
    print(f'\nResults saved to {output}')
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Post-hoc application of metrics to results')
    parser.add_argument('--results_dir', required=True,
                        help='The directory containing the results')
    parser.add_argument('--config_file', required=True,
                        help='The config file with the metrics to evaluate')
    parser.add_argument('--benchmark', help='The benchmark to evaluate')
    parser.add_argument('--dataset', help='The dataset to evaluate')
    parser.add_argument('--method', help='The UE method to evaluate')
    parser.add_argument('--output', default='evaluated_metrics.csv',
                        help='The output file name')
    parser.add_argument('--evaluate_all', action='store_true',
                        help='Evaluate all models instead of the best ones')
    parser.add_argument('--device', default='cuda',
                        help="'cpu' to evaluate on the CPU; default: the "
                             'card')
    args = parser.parse_args(argv)
    for path in (args.results_dir, args.config_file):
        if not Path(path).exists():
            parser.error(f'{path} does not exist')
    evaluate_metrics(args.results_dir, args.config_file, args.benchmark,
                     args.dataset, args.method, args.output,
                     args.evaluate_all, args.device)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
