"""Results tree: the fixed on-disk layout
``results/<benchmark>/<dataset>/<method>/bo_trial_<N>/`` with the
reference's per-trial file map, so post-hoc tooling carries over.

Counterpart of ``nnueehcs_tpu/utility.py``; ``trial_results.csv`` is read
with the standard library's ``csv`` (the JAX package uses pandas): a
:class:`ResultsTable` of named columns, each cell typed as pandas types
the driver's columns (numbers exactly, by Python's ``float``, where
pandas' default parser keeps about 15 significant digits).
"""
from __future__ import annotations

import csv
import math
import os
import re
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Sequence

import numpy as np


def _cell(text: str):
    """A CSV cell as pandas' reader gives it for the driver's columns:
    empty -> nan, ``True``/``False`` -> bool, a number -> int or float,
    else the string."""
    if text == '':
        return float('nan')
    if text in ('True', 'False'):
        return text == 'True'
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        return text


class ResultsTable:
    """The rows of a CSV file as named columns (``table['col']`` is a
    list), read with ``csv``."""

    def __init__(self, path):
        with open(path, newline='') as f:
            reader = csv.reader(f)
            self.columns: List[str] = next(reader)
            self.rows: List[list] = [[_cell(c) for c in row]
                                     for row in reader]

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, column: str) -> list:
        j = self.columns.index(column)
        return [row[j] for row in self.rows]

    def records(self) -> List[Dict]:
        """One dict per row."""
        return [dict(zip(self.columns, row)) for row in self.rows]



def missing(value) -> bool:
    """A cell pandas counts as missing: None or NaN."""
    return value is None or (isinstance(value, float) and math.isnan(value))


def csv_cell(value) -> str:
    """A value as pandas' ``to_csv`` writes it: nan and None empty,
    booleans ``True``/``False``, floats as their shortest repr."""
    if value is None:
        return ''
    if isinstance(value, (bool, np.bool_)):
        return str(bool(value))
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    if isinstance(value, (float, np.floating)):
        return '' if math.isnan(value) else repr(float(value))
    return str(value)


def write_table(path, columns: Sequence[str], rows: Iterable) -> None:
    """Write ``rows`` (sequences in ``columns`` order, or dicts keyed by
    column, a missing key empty) as pandas' ``to_csv(index=False)``
    would."""
    with open(path, 'w', newline='') as f:
        writer = csv.writer(f, lineterminator='\n')
        writer.writerow(columns)
        for row in rows:
            if isinstance(row, dict):
                row = [row.get(c) for c in columns]
            writer.writerow([csv_cell(v) for v in row])


def union_columns(tables: Iterable[Sequence[str]]) -> List[str]:
    """The columns of several tables in order of first appearance, as
    ``pandas.concat`` orders them."""
    columns: List[str] = []
    for names in tables:
        columns += [c for c in names if c not in columns]
    return columns


DefaultFileMap = {
    'optimization_step': 'ax_client_optimization_step.json',
    'model': 'model.pth',
    'trial_results': 'trial_results.csv',
    'training_metrics': 'metrics.csv',
}

DefaultTrialDirRegex = r'^bo_trial_(\d+)$'


class ResultsInstance:
    def __init__(self, results_dir: str, filemap: dict = DefaultFileMap,
                 trial_dir_regex: str = DefaultTrialDirRegex):
        self.results_dir = results_dir
        self.filemap = filemap
        self.files = self._get_files(results_dir)
        self.trial_dir_regex = trial_dir_regex

    def load(self):
        pass

    def _get_files(self, results_dir: str):
        return {key: os.path.join(results_dir, value)
                for key, value in self.filemap.items()}

    def get_model_file(self):
        return self.files['model']

    def get_trial_results_file(self):
        return self.files['trial_results']

    def get_training_metrics_file(self):
        return self.files['training_metrics']

    def get_optimization_step_file(self):
        return self.files['optimization_step']

    def get_benchmark_name(self):
        return Path(self.results_dir).parent.parent.parent.stem

    def get_dataset_name(self):
        return Path(self.results_dir).parent.parent.stem

    def get_method_name(self):
        return Path(self.results_dir).parent.stem

    def get_trial_name(self):
        return Path(self.results_dir).stem

    def get_trial_number(self):
        name = self.get_trial_name()
        match = re.match(self.trial_dir_regex, name)
        if match:
            return int(match.group(1))
        raise ValueError(
            f'Trial name {name} does not match regex {self.trial_dir_regex}')

    def get_metric(self, metric_name: str):
        return self.get_results()[metric_name]

    def get_results(self) -> ResultsTable:
        full_path = Path(self.results_dir) / self.files['trial_results']
        return ResultsTable(full_path)

    def is_finished(self):
        return os.path.exists(self.get_trial_results_file())

    def __str__(self):
        return f'{self.results_dir}'


def find_latest_finished_trial(method_dir):
    """Scan a method directory for the finished trial (has
    ``trial_results.csv``) with the largest trial number.  Returns
    ``(trial_number, trial_dir_path)`` or ``(None, None)`` when no trial has
    finished; shared by the driver's restart and the post-hoc tools."""
    number_re = re.compile(r'\d+')
    best_num, best_dir = None, None
    method_dir = Path(method_dir)
    if not method_dir.is_dir():
        return None, None
    for item in method_dir.iterdir():
        if not item.is_dir():
            continue
        m = number_re.search(item.name)
        if not m:
            continue
        num = int(m.group())
        if (item / 'trial_results.csv').exists() and \
                (best_num is None or num > best_num):
            best_num, best_dir = num, item
    return best_num, best_dir


class ResultsComposite:
    """Enumerates/filters the 4-level results tree
    (benchmark → dataset → method → trial)."""

    def __init__(self, results_dir: str):
        self.results_dir = results_dir

    def get_benchmark_names(self):
        yield from [x.stem for x in Path(self.results_dir).glob('*')]

    def get_dataset_names(self, benchmark_name: str = None):
        benchmark_names = [benchmark_name] if benchmark_name is not None \
            else self.get_benchmark_names()
        for bname in benchmark_names:
            yield from sorted(set(
                x.stem for x in
                Path(os.path.join(self.results_dir, bname)).glob('*')))

    def get_method_names(self, benchmark_name: str = None,
                         dataset_name: str = None):
        benchmark_names = [benchmark_name] if benchmark_name is not None \
            else self.get_benchmark_names()
        for bname in benchmark_names:
            dataset_names = [dataset_name] if dataset_name is not None \
                else self.get_dataset_names(bname)
            for dname in dataset_names:
                yield from sorted(set(
                    x.stem for x in
                    Path(os.path.join(self.results_dir, bname, dname)).glob('*')))

    def get_trial_names(self, benchmark_name: str = None,
                        dataset_name: str = None, method_name: str = None):
        benchmark_names = [benchmark_name] if benchmark_name is not None \
            else self.get_benchmark_names()
        for bname in benchmark_names:
            dataset_names = [dataset_name] if dataset_name is not None \
                else self.get_dataset_names(bname)
            for dname in dataset_names:
                method_names = [method_name] if method_name is not None \
                    else self.get_method_names(bname, dname)
                for mname in method_names:
                    yield from sorted(set(
                        x.stem for x in
                        Path(os.path.join(self.results_dir, bname, dname,
                                          mname)).glob('*')))

    def get_results(self):
        for bname in self.get_benchmark_names():
            for dname in self.get_dataset_names(bname):
                for mname in self.get_method_names(bname, dname):
                    for tname in self.get_trial_names(bname, dname, mname):
                        yield self.get_results_instance(bname, dname, mname, tname)

    def get_results_instance(self, benchmark_name, dataset_name, method_name,
                             trial_name):
        return ResultsInstance(os.path.join(
            self.results_dir, benchmark_name, dataset_name, method_name,
            trial_name))

    def get_num_trials(self, benchmark_name, dataset_name, method_name):
        return len(list(self.get_trial_names(benchmark_name, dataset_name,
                                             method_name)))

    def get_num_methods(self, benchmark_name, dataset_name):
        return len(list(self.get_method_names(benchmark_name, dataset_name)))

    def get_num_datasets(self, benchmark_name):
        return len(list(self.get_dataset_names(benchmark_name)))

    def get_num_benchmarks(self):
        return len(list(self.get_benchmark_names()))

    def apply_functor(self, functor: Callable):
        results = {}
        for bname in self.get_benchmark_names():
            for dname in self.get_dataset_names(bname):
                for mname in self.get_method_names(bname, dname):
                    for tname in self.get_trial_names(bname, dname, mname):
                        results[bname, dname, mname, tname] = functor(
                            self.get_results_instance(bname, dname, mname, tname))
        return results

    def filter_by_metric(self, metric_name: str):
        return self.apply_functor(lambda x: x.get_metric(metric_name))

    def filter(self, functor: Callable):
        res = self.apply_functor(lambda x: (functor(x), x))
        return {key: value[1] for key, value in res.items() if value[0]}

    def filter_by_benchmark(self, benchmark_name: str):
        return self.filter(lambda x: x.get_benchmark_name() == benchmark_name)

    def filter_by_dataset(self, dataset_name: str):
        return self.filter(lambda x: x.get_dataset_name() == dataset_name)

    def filter_by_method(self, method_name: str):
        return self.filter(lambda x: x.get_method_name() == method_name)

    def filter_by_trial(self, trial_name: str):
        return self.filter(lambda x: x.get_trial_name() == trial_name)
