"""Post-hoc ID/OOD classification over every saved BO-trial model
(counterpart of ``examples/bo_driven/classify_posthoc.py``).

Every (trial, model) classification becomes one row of a long table: the
trial's sensitivity, specificity, fpr and fnr at the ``--percentile``
threshold of the ID scores, joined with the trial's BO-time UE distance
(``--ue_dist_column`` of ``trial_results.csv``) as ``ue_dist``. Each
(benchmark, dataset, method) cell is banked in ``cell_<b>_<d>_<m>.csv`` as
it finishes and a later pass resumes from the banked cells; the rows go to
``classification.csv``, and the figures (:mod:`.plotting`) unless
``--no_plots``::

    python -m nnueehcs_tpu_torch.examples.bo_driven.classify_posthoc \\
        --input results --config config.yaml --output classified \\
        [--device cpu] [--no_plots]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ... import config as config_reader
from ...classification import PercentileBasedIdOodClassifier
from ...data_utils import get_dataset_from_config, prepare_dataset_for_use
from ...models.base import resolve_device
from ...training import load_model
from ...utility import (ResultsTable, find_latest_finished_trial,
                        union_columns, write_table)
from . import plotting

_KEEP = ('sensitivity', 'specificity', 'fpr', 'fnr')


def load_cell_datasets(ds_cfg, dataset_name):
    """Scaled (ID, OOD) pair for one dataset split; OOD is scaled by the
    ID statistics first."""
    ds_id = get_dataset_from_config(ds_cfg, dataset_name + '_id')
    ds_ood = get_dataset_from_config(ds_cfg, dataset_name + '_ood')
    ds_ood = prepare_dataset_for_use(ds_ood, {'scaling': True},
                                     scaling_dset=ds_id)
    ds_id = prepare_dataset_for_use(ds_id, {'scaling': True})
    return ds_id, ds_ood


def _by_trial(table: ResultsTable):
    """The rows of ``trial_results.csv`` by trial number (by position when
    the table has no ``trial`` column)."""
    records = table.records()
    if 'trial' in table.columns:
        return {r['trial']: r for r in records}
    return dict(enumerate(records))


def classify_trial_models(method_dir: Path, ds_id, ds_ood, threshold,
                          ue_dist_column: str, device='cuda'):
    """One classification row per saved bo_trial_N model under
    ``method_dir``, each with the trial's BO-time UE distance joined in
    for the correlation scatter; None when no trial has finished."""
    latest, trial_dir = find_latest_finished_trial(method_dir)
    if trial_dir is None:
        return None
    bo_metrics = _by_trial(ResultsTable(Path(trial_dir)
                                        / 'trial_results.csv'))

    classifier = PercentileBasedIdOodClassifier(threshold)
    id_data = (np.asarray(ds_id.input), np.asarray(ds_id.output))
    ood_data = (np.asarray(ds_ood.input), np.asarray(ds_ood.output))

    rows = []
    for trial in range(latest + 1):
        model_file = method_dir / f'bo_trial_{trial}' / 'model.pth'
        if not model_file.exists():
            continue
        model = load_model(str(model_file), device=device)
        scores = classifier.evaluate(model, id_data, ood_data)
        row = {'trial': trial}
        row.update({k: scores[k] for k in _KEEP if k in scores})
        try:
            row['ue_dist'] = float(bo_metrics[trial][ue_dist_column])
        except (KeyError, ValueError, TypeError):
            row['ue_dist'] = float('nan')
        print(trial, row)
        rows.append(row)
    return rows or None


def classify(indir, config, output, percentile=0.8,
             ue_dist_column='percentile_score', benchmarks=None, methods=None,
             device='cuda', plots=True):
    """Classify every cell of ``indir`` that ``config`` knows (and the
    allowlists admit); returns the rows written to
    ``classification.csv`` (None when no trial has finished)."""
    device = resolve_device(device)
    indir, output = Path(indir), Path(output)
    output.mkdir(parents=True, exist_ok=True)
    allow = set(benchmarks.split(',')) if benchmarks else None
    allow_methods = set(methods.split(',')) if methods else None
    cells = []
    dataset_cache = {}
    for method_dir in sorted(indir.glob('*/*/*')):
        if not method_dir.is_dir():
            continue
        bench, dset, method = method_dir.parts[-3:]
        if bench not in config['benchmarks']:
            continue
        if allow is not None and bench not in allow:
            continue
        if allow_methods is not None and method not in allow_methods:
            continue
        # per-cell banking: each cell's rows land in their own CSV as soon
        # as they are done, so an interrupted pass resumes
        cell_csv = output / f'cell_{bench}_{dset}_{method}.csv'
        if cell_csv.exists():
            print(f'resuming: {cell_csv} exists, skipping {bench}/{dset}/'
                  f'{method}')
            table = ResultsTable(cell_csv)
            cells.append((table.columns, table.records()))
            continue
        if (bench, dset) not in dataset_cache:
            ds_cfg = config['benchmarks'][bench]['datasets']
            dataset_cache[(bench, dset)] = load_cell_datasets(ds_cfg, dset)
        ds_id, ds_ood = dataset_cache[(bench, dset)]
        rows = classify_trial_models(method_dir, ds_id, ds_ood, percentile,
                                     ue_dist_column, device)
        if rows is None:
            continue
        for row in rows:
            row.update(benchmark=bench, dataset=dset, method=method)
        columns = union_columns(rows)
        write_table(cell_csv, columns, rows)
        cells.append((columns, rows))

    if not cells:
        print('no finished trials found')
        return None
    rows = [row for _, cell in cells for row in cell]
    write_table(output / 'classification.csv',
                union_columns(columns for columns, _ in cells), rows)
    if plots:
        # the filename keeps the x-axis component
        # (``<bench>_<dset>_trial_sensitivity.png``) so it never collides
        # with collate's sensitivity plot in a shared output directory
        plotting.trial_lines(rows, 'sensitivity', output,
                             name='trial_sensitivity')
        plotting.scatter_with_r(rows, x='ue_dist', y='sensitivity',
                                outdir=output)
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Post-hoc ID/OOD classification of saved BO trials.')
    parser.add_argument('--input', required=True,
                        help='Path to directory containing experiment '
                             'results')
    parser.add_argument('--config', required=True,
                        help='Path to config file')
    parser.add_argument('--output', required=True,
                        help='Path to output directory')
    parser.add_argument('--percentile', '-p', type=float, default=0.8,
                        help='Percentile score threshold for ID/OOD split.')
    parser.add_argument('--ue_dist_column', default='percentile_score',
                        help='trial_results.csv column to correlate '
                             'sensitivity with')
    parser.add_argument('--benchmarks', default=None,
                        help='Comma-separated benchmark allowlist')
    parser.add_argument('--methods', default=None,
                        help='Comma-separated UQ-method allowlist (a mixed '
                             'tree pairs each method with the config it '
                             'trained under)')
    parser.add_argument('--device', default='cuda',
                        help="'cpu' to classify on the CPU; default: the "
                             'card')
    parser.add_argument('--no_plots', action='store_true',
                        help='Write the CSVs only (no matplotlib needed)')
    args = parser.parse_args(argv)
    if not Path(args.input).exists():
        parser.error(f'{args.input} does not exist')
    classify(args.input, config_reader.load_path(args.config), args.output,
             args.percentile, args.ue_dist_column, args.benchmarks,
             args.methods, args.device, plots=not args.no_plots)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
