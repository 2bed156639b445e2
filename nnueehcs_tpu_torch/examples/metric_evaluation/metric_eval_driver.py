"""Fan post-hoc metric evaluation out over the (benchmark x dataset) grid
(counterpart of ``examples/metric_evaluation/metric_eval_driver.py``).

One subprocess per (benchmark, dataset) cell runs
:mod:`.evaluate_metrics` with ``--max_tasks`` at a time, ``--skip-completed``
keeps the cells whose CSV exists, and the per-cell CSVs are combined into
one (a cell whose task failed gets one ``FAILED`` row)::

    python -m nnueehcs_tpu_torch.examples.metric_evaluation.metric_eval_driver \\
        --results_dir results --config_file config.yaml [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ...utility import ResultsComposite, ResultsTable, write_table
from .. import package_env
from .evaluate_metrics import COLUMNS

MODULE = 'nnueehcs_tpu_torch.examples.metric_evaluation.evaluate_metrics'


def run_evaluate_metrics(results_dir, config_file, benchmark, dataset,
                         outfile, rundir, device='cuda'):
    cmd = [sys.executable, '-m', MODULE, '--results_dir', results_dir,
           '--config_file', config_file, '--benchmark', benchmark,
           '--dataset', dataset, '--output', outfile, '--device', device]
    os.makedirs(rundir, exist_ok=True)
    log = os.path.join(rundir, f'{benchmark}_{dataset}')
    with open(f'{log}.out', 'w') as out, open(f'{log}.err', 'w') as err:
        rc = subprocess.run(cmd, stdout=out, stderr=err,
                            env=package_env()).returncode
    return benchmark, dataset, outfile, rc


def combine_results(task_results, output):
    rows = []
    for benchmark, dataset, outfile, rc in task_results:
        if rc == 0 and os.path.exists(outfile):
            rows.extend(ResultsTable(outfile).records())
        else:
            rows.append(dict(zip(COLUMNS, [benchmark, dataset, 'FAILED',
                                           'FAILED', 'ERROR', 'ERROR',
                                           float('nan')])))
    write_table(output, COLUMNS, rows)
    print(f'Combined results saved to {output}')
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Fan post-hoc metric evaluation out over the results '
                    'tree.')
    parser.add_argument('--results_dir', required=True)
    parser.add_argument('--config_file', required=True)
    parser.add_argument('--output', default='evaluated_metrics_combined.csv')
    parser.add_argument('--rundir', default='./metric_eval_rundir')
    parser.add_argument('--max_tasks', default=2, type=int)
    parser.add_argument('--skip-completed', dest='skip_completed',
                        action='store_true')
    parser.add_argument('--device', default='cuda',
                        help="the tasks' device: 'cpu' to evaluate on the "
                             'CPU; default: the card')
    parser.add_argument('--benchmarks', default=None,
                        help='Comma-separated benchmark allowlist, for a '
                             'tree that mixes cells trained under different '
                             'configs: fan each subset out with its config')
    args = parser.parse_args(argv)
    for path in (args.results_dir, args.config_file):
        if not Path(path).exists():
            parser.error(f'{path} does not exist')
    composite = ResultsComposite(args.results_dir)
    allow = set(args.benchmarks.split(',')) if args.benchmarks else None
    pairs = [(bench, dset) for bench in composite.get_benchmark_names()
             if allow is None or bench in allow
             for dset in composite.get_dataset_names(bench)]

    os.makedirs(args.rundir, exist_ok=True)
    tasks = []
    for bench, dset in pairs:
        outfile = os.path.join(args.rundir, f'metrics_{bench}_{dset}.csv')
        if args.skip_completed and os.path.exists(outfile):
            print(f'Skipping completed {bench}/{dset}')
            tasks.append((bench, dset, outfile, 0))
            continue
        tasks.append((bench, dset, outfile, None))

    to_run = [t for t in tasks if t[3] is None]
    print(f'Running {len(to_run)} tasks with {args.max_tasks} workers')
    results = [t for t in tasks if t[3] == 0]
    with ThreadPoolExecutor(max_workers=args.max_tasks) as pool:
        futures = [pool.submit(run_evaluate_metrics, args.results_dir,
                               args.config_file, b, d, o, args.rundir,
                               args.device)
                   for b, d, o, _ in to_run]
        results.extend(fut.result() for fut in futures)

    combine_results(results, args.output)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
