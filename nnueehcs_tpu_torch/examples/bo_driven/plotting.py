"""Plotting helpers of the BO post-hoc tools (counterpart of
``examples/bo_driven/plotting.py``).

:mod:`.collate` and :mod:`.classify_posthoc` reduce a results tree to one
long table, a list of row dicts with one row per ``(benchmark, dataset,
method, source, trial)``; every figure below groups it by cell and series
as the JAX tools' pandas groupbys do (sorted keys, rows with a missing key
left out, a missing value NaN). Figure files are named
``<benchmark>_<dataset>_<...>.png``.

matplotlib is imported when a figure is drawn, so the tools import
without it; a tool asked to plot where it is missing raises, and the
tools' ``--no_plots`` leaves the figures out.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ...utility import missing, union_columns

CELL = ['benchmark', 'dataset']
SERIES = ['method', 'source']
STATISTICS = {'max': np.max, 'min': np.min, 'median': np.median,
              'mean': np.mean}


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend; raises ImportError naming
    matplotlib and ``--no_plots`` where it is missing."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError('plotting needs matplotlib, which is not '
                          'installed; pass --no_plots to leave the figures '
                          'out') from e
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def value(row, column):
    return row.get(column, float('nan'))


def dropna(rows, subset):
    return [r for r in rows if not any(missing(value(r, c)) for c in subset)]


def groupby(rows, keys):
    """``[(key, rows)]`` sorted by key, rows whose key has a missing part
    left out (pandas' ``groupby(keys, sort=True)``); a single key is the
    value itself, several a tuple."""
    groups: Dict[tuple, list] = {}
    for row in rows:
        key = tuple(value(row, k) for k in keys)
        if any(missing(k) for k in key):
            continue
        groups.setdefault(key, []).append(row)
    return [(key if len(keys) > 1 else key[0], groups[key])
            for key in sorted(groups)]


def _series_label(key) -> str:
    parts = [str(p) for p in (key if isinstance(key, tuple) else (key,)) if p]
    if len(parts) >= 2:
        return f'{parts[0]} ({parts[1]})'
    return parts[0] if parts else ''


def _each_cell(rows):
    plt = pyplot()
    for (bench, dset), cell in groupby(rows, CELL):
        fig, ax = plt.subplots()
        ax.set_title(f'{bench}/{dset}')
        yield (bench, dset), cell, fig, ax
        plt.close(fig)


def _series_in(cell):
    keys = [k for k in SERIES if k in union_columns(cell)]
    return groupby(cell, keys) if keys else [('', cell)]


def trial_lines(rows, quantity: str, outdir, x: str = 'trial',
                name: str | None = None):
    """One figure per (benchmark, dataset): ``quantity`` against ``x`` with
    a line per method/source series. ``name`` overrides the
    ``<quantity>`` part of the filename."""
    if quantity not in union_columns(rows):
        return
    name = name or quantity
    for (bench, dset), cell, fig, ax in _each_cell(rows):
        drew = False
        for key, series in _series_in(cell):
            s = dropna(series, [quantity])
            if not s:
                continue
            s = sorted(s, key=lambda r: value(r, x))
            ax.plot([value(r, x) for r in s], [r[quantity] for r in s],
                    label=_series_label(key))
            drew = True
        ax.set_xlabel(x.capitalize())
        ax.set_ylabel(quantity)
        if drew:
            ax.legend()
        fig.savefig(f'{outdir}/{bench}_{dset}_{name}.png')


def scatter_with_r(rows, x: str, y: str, outdir):
    """Per-cell scatter of ``y`` vs ``x`` with the Pearson r in the
    title."""
    cols = union_columns(rows)
    if x not in cols or y not in cols:
        return
    for (bench, dset), cell, fig, ax in _each_cell(rows):
        pts = dropna(cell, [x, y])
        for key, series in _series_in(pts):
            ax.scatter([r[x] for r in series], [r[y] for r in series],
                       label=_series_label(key))
        if len(pts) >= 2:
            r = np.corrcoef(np.array([p[x] for p in pts], float),
                            np.array([p[y] for p in pts], float))[0, 1]
            ax.set_title(f'{bench}/{dset} R2: {round(float(r), 2)}')
        ax.set_xlabel(x.capitalize())
        ax.set_ylabel(y)
        if pts:
            ax.legend()
        fig.savefig(f'{outdir}/{bench}_{dset}_{x}_{y}.png')


def series_bars(rows, quantity: str, outdir, statistic: str = 'max',
                suffix: str | None = None):
    """Per-cell bar chart: one bar per method/source series, showing the
    ``statistic`` (max, min, median or mean) of ``quantity`` over its
    trials."""
    if quantity not in union_columns(rows):
        return
    reduce = STATISTICS[statistic]
    suffix = f'_{statistic}_bar' if suffix is None else suffix
    for (bench, dset), cell, fig, ax in _each_cell(rows):
        labels, values = [], []
        for key, series in _series_in(cell):
            col = [r[quantity] for r in dropna(series, [quantity])]
            if not col:
                continue
            labels.append(_series_label(key))
            values.append(reduce(np.array(col)))
        for label, v in zip(labels, values):
            ax.bar(label, v, label=label)
        ax.set_xlabel('Method')
        ax.set_ylabel(quantity)
        ax.set_xticks([])
        if labels:
            ax.legend(loc='center right')
        fig.savefig(f'{outdir}/{bench}_{dset}_{quantity}{suffix}.png')


def bars_at_best(rows, select_by: str, show: str, outdir):
    """Per-cell bar chart of ``show`` taken at each series' best
    (``select_by``-maximising, the first such) trial."""
    cols = union_columns(rows)
    if select_by not in cols or show not in cols:
        return
    for (bench, dset), cell, fig, ax in _each_cell(rows):
        drew = False
        for key, series in _series_in(cell):
            s = dropna(series, [select_by, show])
            if not s:
                continue
            best = max(s, key=lambda r: r[select_by])
            label = _series_label(key)
            ax.bar(label, best[show], label=label)
            drew = True
        ax.set_xlabel('Method')
        ax.set_ylabel(show)
        ax.set_xticks([])
        if drew:
            ax.legend(loc='center right')
        fig.savefig(f'{outdir}/{bench}_{dset}_{show}_bar.png')
