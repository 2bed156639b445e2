"""Collate results across one or more experiment output directories
(counterpart of ``examples/bo_driven/collate.py``).

The whole tree is flattened into one long table (one row per benchmark x
dataset x method x source x trial, from each cell's latest finished
``trial_results.csv``); the summary and every figure group it
(:mod:`.plotting`)::

    python -m nnueehcs_tpu_torch.examples.bo_driven.collate \\
        --input results [--input other_results] --output collated \\
        [--no_plots]

Writes ``summary.csv`` (per cell and series: the headline metric's best
trial, best value and median) and, unless ``--no_plots``, the figures.
Reads files only: it runs no model.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ...utility import (ResultsTable, find_latest_finished_trial, missing,
                        write_table)
from . import plotting

# metric preference chain for the headline "UE distance" quantity
_METRIC_FALLBACK = ['wasserstein_distance', 'jensen_shannon_distance',
                    'sensitivity', 'percentile_score', 'score_dist']
SUMMARY_COLUMNS = ['benchmark', 'dataset', 'method', 'source', 'trials',
                   'metric', 'best_trial', 'best_value', 'median_value']


def load_results_frame(inputs):
    """Flatten ``<input>/<benchmark>/<dataset>/<method>/bo_trial_*`` trees
    into one list of row dicts. Returns ``(rows, absent)`` where absent
    lists (source, benchmark, dataset, method) cells with no finished
    trial."""
    rows, absent = [], []
    for input_dir in map(Path, inputs):
        source = input_dir.name
        for method_dir in sorted(input_dir.glob('*/*/*')):
            if not method_dir.is_dir():
                continue
            bench, dset, method = method_dir.parts[-3:]
            _, trial_dir = find_latest_finished_trial(method_dir)
            if trial_dir is None:
                absent.append((source, bench, dset, method))
                continue
            for row in ResultsTable(
                    Path(trial_dir) / 'trial_results.csv').records():
                row.update(source=source, benchmark=bench, dataset=dset,
                           method=method, latest_trial_dir=str(trial_dir))
                rows.append(row)
    return rows, absent


def headline_metric(rows) -> str | None:
    """First preference-chain metric with any value in ``rows`` (applied
    per cell and series, so mixed-method trees all get summarised)."""
    for name in _METRIC_FALLBACK:
        if any(not missing(plotting.value(r, name)) for r in rows):
            return name
    return None


def summarize(rows, absent):
    """Per cell and series, the headline metric's best trial, best value
    and median (the fallback chain resolved per series, so a method that
    reports only e.g. percentile_score still appears); printed, and
    returned as row dicts."""
    summary = []
    for key, g in plotting.groupby(rows, ['benchmark', 'dataset', 'method',
                                          'source']):
        metric = headline_metric(g)
        if metric is None:
            continue
        col = plotting.dropna(g, [metric])
        best = max(col, key=lambda r: r[metric])
        trial = plotting.value(best, 'trial')
        summary.append({
            'benchmark': key[0], 'dataset': key[1], 'method': key[2],
            'source': key[3], 'trials': len(g), 'metric': metric,
            'best_trial': -1 if missing(trial) else int(trial),
            'best_value': round(float(best[metric]), 2),
            'median_value': round(float(np.median([r[metric] for r in col])),
                                  2),
        })
    if summary:
        widths = {c: max(len(c), *(len(str(r[c])) for r in summary))
                  for c in SUMMARY_COLUMNS}
        for line in [dict(zip(SUMMARY_COLUMNS, SUMMARY_COLUMNS))] + summary:
            print(' '.join(str(line[c]).rjust(widths[c])
                           for c in SUMMARY_COLUMNS))
    for source, bench, dset, method in absent:
        print(f'{bench}/{dset}/{method} [{source}]: no finished trial')
    return summary


def plot(rows, output):
    plotting.trial_lines(rows, 'sensitivity', output)
    plotting.series_bars(rows, 'sensitivity', output)
    plotting.series_bars(rows, 'sensitivity', output, statistic='median')
    plotting.trial_lines(rows, 'ue_time', output)
    plotting.trial_lines(rows, 'ue_throughput', output)
    plotting.bars_at_best(rows, select_by='sensitivity', show='ue_time',
                          outdir=output)
    # the headline metric may differ from sensitivity (BO-time metrics)
    metric = headline_metric(rows)
    if metric and metric != 'sensitivity':
        plotting.trial_lines(rows, metric, output)
        plotting.series_bars(rows, metric, output)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Collate BO results across output directories.')
    parser.add_argument('--input', dest='inputs', action='append',
                        default=[], help='Path to a directory of experiment '
                                         'results (repeatable)')
    parser.add_argument('--output', required=True,
                        help='Path to output directory')
    parser.add_argument('--no_plots', action='store_true',
                        help='Write summary.csv only (no matplotlib needed)')
    args = parser.parse_args(argv)
    for path in args.inputs:
        if not Path(path).exists():
            parser.error(f'{path} does not exist')
    output = Path(args.output)
    output.mkdir(parents=True, exist_ok=True)

    rows, absent = load_results_frame(args.inputs)
    summary = summarize(rows, absent)
    if summary:
        write_table(output / 'summary.csv', SUMMARY_COLUMNS, summary)
    if not args.no_plots:
        plot(rows, output)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
