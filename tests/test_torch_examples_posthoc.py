"""The port's post-hoc tools (``nnueehcs_tpu_torch/examples/metric_evaluation``
and ``examples/bo_driven/{classify_posthoc,collate,plotting}.py``) against
the JAX scripts of ``examples/`` on one tiny results tree written by the
JAX driver (minibude at 900 rows, an ensemble and an MVE cell of 2 trials
of 1 epoch, the CPU): the same row keys, metric values within 1e-5 but for
the timed and memory metrics, the Pareto cases of
``tests/test_posthoc_tools.py``, FAILED rows, resume from banked cells, the
allowlists, the same figure files, and the metric fan-out's combined CSV.
The two packages load the same ``model.pth`` bundles; MC dropout is left
out because the two packages draw other masks."""
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import yaml
from click.testing import CliRunner

from nnueehcs_tpu import driver as jax_driver
from nnueehcs_tpu_torch import datagen
from nnueehcs_tpu_torch.examples.bo_driven import (classify_posthoc, collate,
                                                   plotting)
from nnueehcs_tpu_torch.examples.metric_evaluation import (evaluate_metrics,
                                                           metric_eval_driver)
from nnueehcs_tpu_torch.utility import union_columns

from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
# the metrics whose values are times, rates or memory: compared by key only
TIMED = {'base_model_runtime', 'uncertainty_estimating_runtime',
         'base_model_throughput', 'uncertainty_estimating_throughput',
         'max_memory_usage'}
KEYS = ['benchmark', 'dataset', 'method', 'trial', 'metric', 'objective']
METHODS = ('ensemble', 'mve')


def load_script(path, name):
    """A JAX script of ``examples/`` as a module (its directory first on
    ``sys.path`` for its sibling imports)."""
    directory = str(path.parent)
    if directory not in sys.path:
        sys.path.insert(0, directory)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module')
def jax_scripts():
    bo = REPO / 'examples' / 'bo_driven'
    me = REPO / 'examples' / 'metric_evaluation'
    return {'evaluate_metrics': load_script(me / 'evaluate_metrics.py',
                                            'jax_evaluate_metrics'),
            'metric_eval_driver': load_script(me / 'metric_eval_driver.py',
                                              'jax_metric_eval_driver'),
            'classify_posthoc': load_script(bo / 'classify_posthoc.py',
                                            'jax_classify_posthoc'),
            'collate': load_script(bo / 'collate.py', 'jax_collate'),
            'plotting': load_script(bo / 'plotting.py', 'jax_plotting')}


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """``(results_dir, config_path, config)``: the JAX driver's tree."""
    tmp = tmp_path_factory.mktemp('posthoc')
    ipt, opt = datagen.generate_minibude(900)
    path = str(tmp / 'bude.h5')
    datagen.write_hdf5(path, ipt, opt, 'BUDEKernel')
    arch = [{'Linear': {'args': [6, 16]}}, {'ReLU': {}},
            {'Linear': {'args': [16, 1]}}]
    datasets = {s: {'format': 'hdf5', 'path': path,
                    'group_name': 'BUDEKernel', 'input_dataset': 'input',
                    'output_dataset': 'output', 'percentiles': p,
                    'dtype': 'float32'}
                for s, p in [('tails_id', '[0, 70]'),
                             ('tails_ood', '[70, 100]')]}
    timed = {'trials': 2, 'warmup': 1}
    config = {
        'trainer': {'accelerator': 'cpu', 'max_epochs': 1,
                    'gradient_clip_val': 5},
        'training': {'loss': 'l1_loss', 'scaling': True,
                     'validation_split': 0.2, 'parameter_space': [
                         {'name': 'learning_rate', 'type': 'fixed',
                          'value': 1e-3},
                         {'name': 'weight_decay', 'type': 'fixed',
                          'value': 0},
                         {'name': 'batch_size', 'type': 'fixed',
                          'value': 128}]},
        'benchmarks': {'minibude': {'model': {'architecture': arch},
                                    'datasets': datasets}},
        'uq_methods': {
            'ensemble': {'parameter_space': [
                {'name': 'num_models', 'type': 'range', 'bounds': [2, 4]}]},
            'mve': {'parameter_space': [
                {'name': 'min_variance', 'type': 'range',
                 'bounds': [1e-7, 1e-3], 'log_scale': True}]}},
        'bo_config': {'trials': 2, 'max_failures': 1, 'evaluation_metric': [
            {'name': 'percentile_score', 'percentile': 95},
            {'name': 'uncertainty_estimating_throughput'}]},
        'evaluation': {'metrics': [
            {'name': 'tnr_at_tpr', 'target_tpr': 0.95, 'reversed': False},
            {'name': 'percentile_classification', 'threshold': 0.9,
             'reversed': False},
            {'name': 'percentile_classification', 'threshold': 0.8,
             'reversed': True},
            {'name': 'auroc'},
            dict(name='runtime', **timed),
            dict(name='uncertainty_estimating_throughput', **timed),
            {'name': 'max_memory_usage'}]},
    }
    out = str(tmp / 'results')
    for method in METHODS:
        jax_driver.run_bo_experiment('minibude', method, config, 'tails',
                                     out)
    config_path = tmp / 'config.yaml'
    config_path.write_text(yaml.safe_dump(config))
    return out, str(config_path), config


def jax_cli(command, args):
    return CliRunner().invoke(command, args)


def assert_metric_rows_match(port_csv, jax_csv):
    port, jax = pd.read_csv(port_csv), pd.read_csv(jax_csv)
    assert list(port.columns) == list(jax.columns) == KEYS + ['value']
    assert port[KEYS].values.tolist() == jax[KEYS].values.tolist()
    for (_, p), (_, j) in zip(port.iterrows(), jax.iterrows()):
        if p['metric'] in TIMED or p['metric'] == 'FAILED':
            continue
        assert abs(float(p['value']) - float(j['value'])) <= TOL, \
            (p.tolist(), j.tolist())
    return port


@pytest.mark.parametrize('extra', [[], ['--evaluate_all'],
                                   ['--method', 'mve']],
                         ids=['pareto', 'evaluate_all', 'method'])
def test_evaluate_metrics_matches_jax(tree, jax_scripts, tmp_path, extra):
    out, cfg, _ = tree
    jax_csv, port_csv = str(tmp_path / 'jax.csv'), str(tmp_path / 'port.csv')
    res = jax_cli(jax_scripts['evaluate_metrics'].evaluate_metrics,
                  ['--results_dir', out, '--config_file', cfg, '--output',
                   jax_csv, '--platform', 'cpu', *extra])
    assert res.exit_code == 0, res.output
    assert evaluate_metrics.main(['--results_dir', out, '--config_file',
                                  cfg, '--output', port_csv, '--device',
                                  'cpu', *extra]) == 0
    port = assert_metric_rows_match(port_csv, jax_csv)
    assert set(port['metric']) >= {'auroc', 'tnr_at_tpr95',
                                   'percentile_classification_90',
                                   'percentile_classification_reversed_80'}
    if extra == ['--method', 'mve']:
        assert set(port['method']) == {'mve'}


def test_evaluate_metrics_absent_method_writes_nothing(tree, jax_scripts,
                                                       tmp_path):
    """An explicit --method absent from the tree does not fall back to the
    other methods: both exit non-zero and write no file."""
    out, cfg, _ = tree
    res = jax_cli(jax_scripts['evaluate_metrics'].evaluate_metrics,
                  ['--results_dir', out, '--config_file', cfg, '--output',
                   str(tmp_path / 'jax.csv'), '--method', 'pager'])
    assert res.exit_code != 0
    with pytest.raises(SystemExit) as info:
        evaluate_metrics.main(['--results_dir', out, '--config_file', cfg,
                               '--output', str(tmp_path / 'port.csv'),
                               '--method', 'pager', '--device', 'cpu'])
    assert info.value.code not in (0, None)
    assert not os.listdir(tmp_path)


def test_evaluate_metrics_failed_trial_rows(tree, jax_scripts, tmp_path):
    """A trial whose bundle is not a bundle gets a FAILED row in both, and
    the other trials are evaluated."""
    out, cfg, _ = tree
    broken = tmp_path / 'results'
    shutil.copytree(out, broken)
    (broken / 'minibude' / 'tails' / 'ensemble' / 'bo_trial_0'
     / 'model.pth').write_bytes(b'not a bundle')
    jax_csv, port_csv = str(tmp_path / 'jax.csv'), str(tmp_path / 'port.csv')
    args = ['--results_dir', str(broken), '--config_file', cfg,
            '--evaluate_all', '--method', 'ensemble']
    res = jax_cli(jax_scripts['evaluate_metrics'].evaluate_metrics,
                  args + ['--output', jax_csv])
    assert res.exit_code == 0, res.output
    assert evaluate_metrics.main(args + ['--output', port_csv, '--device',
                                         'cpu']) == 0
    port = assert_metric_rows_match(port_csv, jax_csv)
    failed = port[port['metric'] == 'FAILED']
    assert failed['trial'].tolist() == ['bo_trial_0']
    assert (port['trial'] == 'bo_trial_1').sum() > 1


def test_evaluate_metrics_metric_refusal_is_the_trials(tree, tmp_path,
                                                        monkeypatch):
    """A metric that refuses a trial's UEs (``MetricError``) gives that
    trial a FAILED row and the run goes on."""
    from nnueehcs_tpu_torch.evaluation import AUROC, MetricError

    def refuse(self, id_scores, ood_scores):
        raise MetricError('AUROC requires both classes present')

    monkeypatch.setattr(AUROC, '_evaluate_scores', refuse)
    out, cfg, _ = tree
    port_csv = tmp_path / 'port.csv'
    assert evaluate_metrics.main(
        ['--results_dir', out, '--config_file', cfg, '--evaluate_all',
         '--method', 'ensemble', '--output', str(port_csv),
         '--device', 'cpu']) == 0
    port = pd.read_csv(port_csv)
    assert port['metric'].tolist() == ['FAILED', 'FAILED']
    assert port['trial'].tolist() == ['bo_trial_0', 'bo_trial_1']


def test_evaluate_metrics_kernel_refusal_ends_the_run(tree, tmp_path,
                                                       monkeypatch):
    """A kernel wrapper's own ValueError (a device or layout it has no
    kernel for) is not a trial's fault: it ends the run, which exits
    non-zero and writes no file."""
    from nnueehcs_tpu_torch.models import ensemble

    def refuse(fw, x):
        raise ValueError(f'no fused ensemble kernel for device {x.device}')

    monkeypatch.setattr(ensemble, 'fused_forward_prefolded', refuse)
    out, cfg, _ = tree
    port_csv = tmp_path / 'port.csv'
    with pytest.raises(ValueError, match='no fused ensemble kernel'):
        evaluate_metrics.main(
            ['--results_dir', out, '--config_file', cfg, '--evaluate_all',
             '--method', 'ensemble', '--output', str(port_csv),
             '--device', 'cpu'])
    assert not port_csv.exists()


class _StubMetric:
    def __init__(self, name, direction):
        self._name, self._dir = name, direction

    def get_metrics(self):
        return [self._name]

    def get_objectives(self):
        return [{'name': self._name, 'type': self._dir}]


class _StubInstance:
    def __init__(self, path):
        self._path = path

    def get_trial_results_file(self):
        return str(self._path)


PARETO_CASES = {
    # tests/test_posthoc_tools.py: a failed NaN row must not poison the
    # mask; all failed gives nothing
    'failed_nan_row': ({'percentile_score': [float('nan'), 0.5, 0.3, 0.4],
                        'uncertainty_estimating_throughput':
                            [float('nan'), 10.0, 5.0, 20.0],
                        'failed': [True, False, False, False]},
                       [('percentile_score', 'minimize'),
                        ('uncertainty_estimating_throughput', 'maximize')]),
    'all_failed': ({'percentile_score': [float('nan')],
                    'uncertainty_estimating_throughput': [float('nan')],
                    'failed': [True]},
                   [('percentile_score', 'minimize'),
                    ('uncertainty_estimating_throughput', 'maximize')]),
    'one_objective_ties': ({'percentile_score': [0.2, 0.1, 0.1, 0.3]},
                           [('percentile_score', 'minimize')]),
    'one_objective_max': ({'auroc': [0.6, 0.9, float('nan'), 0.9]},
                          [('auroc', 'maximize')]),
    'dominated_equal_rows': ({'a': [1.0, 1.0, 2.0, 0.5],
                              'b': [3.0, 3.0, 1.0, 0.5]},
                             [('a', 'maximize'), ('b', 'maximize')]),
}


@pytest.mark.parametrize('case', sorted(PARETO_CASES))
def test_pareto_selection_matches_jax(jax_scripts, tmp_path, case):
    columns, objectives = PARETO_CASES[case]
    n = len(next(iter(columns.values())))
    csv_path = tmp_path / 'trial_results.csv'
    pd.DataFrame({'trial': list(range(n)),
                  'log_path': [f'r/bo_trial_{i}' for i in range(n)],
                  **columns}).to_csv(csv_path, index=False)
    metrics = [_StubMetric(*o) for o in objectives]
    want = sorted(int(r['trial']) for r in jax_scripts['evaluate_metrics']
                  .find_pareto_optimal_runs(_StubInstance(csv_path), metrics))
    got = sorted(r['trial'] for r in evaluate_metrics.find_pareto_optimal_runs(
        _StubInstance(csv_path), metrics))
    assert got == want
    if case == 'failed_nan_row':
        assert got == [2, 3]
    if case == 'all_failed':
        assert got == []


def figures(directory):
    return sorted(p.name for p in Path(directory).glob('*.png'))


def test_classify_posthoc_matches_jax(tree, jax_scripts, tmp_path):
    out, cfg, _ = tree
    jax_out, port_out = tmp_path / 'jax', tmp_path / 'port'
    res = jax_cli(jax_scripts['classify_posthoc'].main,
                  ['--input', out, '--config', cfg, '--output', str(jax_out),
                   '-p', '0.8'])
    assert res.exit_code == 0, res.output
    assert classify_posthoc.main(['--input', out, '--config', cfg,
                                  '--output', str(port_out), '-p', '0.8',
                                  '--device', 'cpu']) == 0
    port = pd.read_csv(port_out / 'classification.csv')
    jax = pd.read_csv(jax_out / 'classification.csv')
    assert list(port.columns) == list(jax.columns)
    assert len(port) == len(jax) == 2 * len(METHODS)
    for col in port.columns:
        if pd.api.types.is_numeric_dtype(port[col]):
            np.testing.assert_allclose(port[col], jax[col], atol=TOL, rtol=0)
        else:
            assert port[col].tolist() == jax[col].tolist()
    assert figures(port_out) == figures(jax_out) != []
    assert sorted(p.name for p in port_out.glob('cell_*.csv')) == \
        sorted(p.name for p in jax_out.glob('cell_*.csv'))


def test_classify_posthoc_resumes_from_banked_cells(tmp_path, jax_scripts):
    """tests/test_posthoc_tools.py's case: the banked cell short-circuits
    before any dataset or model load, in both."""
    (tmp_path / 'results' / 'b1' / 'tails' / 'ensemble').mkdir(parents=True)
    banked = pd.DataFrame({
        'trial': [0, 1], 'sensitivity': [0.4, 0.6],
        'specificity': [0.8, 0.8], 'fpr': [0.2, 0.2], 'fnr': [0.6, 0.4],
        'ue_dist': [0.1, 0.2], 'benchmark': ['b1', 'b1'],
        'dataset': ['tails', 'tails'], 'method': ['ensemble', 'ensemble']})
    cfg = tmp_path / 'cfg.yaml'
    cfg.write_text(yaml.safe_dump({'benchmarks': {'b1': {'datasets': {}}}}))
    finals = []
    for name in ('jax', 'port'):
        out = tmp_path / name
        out.mkdir()
        banked.to_csv(out / 'cell_b1_tails_ensemble.csv', index=False)
        args = ['--input', str(tmp_path / 'results'), '--config', str(cfg),
                '--output', str(out), '-p', '0.8']
        if name == 'jax':
            res = jax_cli(jax_scripts['classify_posthoc'].main, args)
            assert res.exit_code == 0 and 'resuming' in res.output
        else:
            assert classify_posthoc.main(args + ['--device', 'cpu']) == 0
        finals.append(pd.read_csv(out / 'classification.csv'))
    pd.testing.assert_frame_equal(finals[0], finals[1])
    assert len(finals[1]) == 2


@pytest.mark.parametrize('allow', [['--benchmarks', 'minibude'],
                                   ['--methods', 'mve'],
                                   ['--benchmarks', 'other']],
                         ids=['benchmarks', 'methods', 'none_admitted'])
def test_classify_posthoc_allowlists_match_jax(tree, jax_scripts, tmp_path,
                                               allow):
    out, cfg, _ = tree
    results = tmp_path / 'results'
    shutil.copytree(out, results)
    # a benchmark the config does not know: skipped by both
    (results / 'other' / 'tails' / 'ensemble').mkdir(parents=True)
    jax_out, port_out = tmp_path / 'jax', tmp_path / 'port'
    res = jax_cli(jax_scripts['classify_posthoc'].main,
                  ['--input', str(results), '--config', cfg, '--output',
                   str(jax_out), *allow])
    assert res.exit_code == 0, res.output
    assert classify_posthoc.main(['--input', str(results), '--config', cfg,
                                  '--output', str(port_out), '--device',
                                  'cpu', '--no_plots', *allow]) == 0
    assert sorted(p.name for p in port_out.glob('*.csv')) == \
        sorted(p.name for p in jax_out.glob('*.csv'))
    if allow[0] == '--methods':
        assert set(pd.read_csv(port_out / 'classification.csv')['method']) \
            == {'mve'}


def test_collate_matches_jax(tree, jax_scripts, tmp_path):
    out, _, _ = tree
    jax_out, port_out = tmp_path / 'jax', tmp_path / 'port'
    res = jax_cli(jax_scripts['collate'].main,
                  ['--input', out, '--output', str(jax_out)])
    assert res.exit_code == 0, res.output
    assert collate.main(['--input', out, '--output', str(port_out)]) == 0
    port = pd.read_csv(port_out / 'summary.csv')
    pd.testing.assert_frame_equal(port, pd.read_csv(jax_out / 'summary.csv'))
    assert port['method'].tolist() == list(METHODS)
    assert figures(port_out) == figures(jax_out) != []
    # the port's rows are the JAX frame's, column for column
    frame, missing = jax_scripts['collate'].load_results_frame([out])
    rows, port_missing = collate.load_results_frame([out])
    assert port_missing == missing
    assert union_columns(rows) == list(frame.columns)
    assert len(rows) == len(frame)


def test_collate_no_plots_writes_the_summary_only(tree, tmp_path):
    out, _, _ = tree
    assert collate.main(['--input', out, '--output', str(tmp_path),
                         '--no_plots']) == 0
    assert sorted(os.listdir(tmp_path)) == ['summary.csv']


def test_metric_eval_driver_matches_jax(tree, tmp_path):
    """One task a (benchmark, dataset) cell, each a subprocess: the port's
    combined CSV holds the JAX driver's rows; --skip-completed reruns
    nothing."""
    out, cfg, _ = tree
    jax_csv, port_csv = tmp_path / 'jax.csv', tmp_path / 'port.csv'
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS='1')
    proc = subprocess.run(
        [sys.executable, str(REPO / 'examples' / 'metric_evaluation'
                             / 'metric_eval_driver.py'),
         '--results_dir', out, '--config_file', cfg, '--output',
         str(jax_csv), '--rundir', str(tmp_path / 'jax_rundir'),
         '--max_tasks', '1', '--platform', 'cpu'],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    port_args = ['--results_dir', out, '--config_file', cfg, '--output',
                 str(port_csv), '--rundir', str(tmp_path / 'port_rundir'),
                 '--max_tasks', '1', '--device', 'cpu']
    assert metric_eval_driver.main(port_args) == 0
    port = assert_metric_rows_match(port_csv, jax_csv)
    assert (port['metric'] != 'FAILED').all()
    assert metric_eval_driver.main(port_args + ['--skip-completed']) == 0
    pd.testing.assert_frame_equal(pd.read_csv(port_csv), port)


def test_metric_eval_driver_failed_task_and_filter(tmp_path, monkeypatch,
                                                   jax_scripts):
    """--benchmarks restricts the fan-out, and a failed task leaves one
    FAILED row, as in the JAX driver (tests/test_workflow.py's case)."""
    for bench in ('minibude', 'binomial_options'):
        for dset in ('tails', 'gaps'):
            (tmp_path / 'results' / bench / dset / 'kde').mkdir(parents=True)
    cfg = tmp_path / 'cfg.yaml'
    cfg.write_text('{}\n')
    frames = []
    for name, module in (('jax', jax_scripts['metric_eval_driver']),
                         ('port', metric_eval_driver)):
        ran = []
        monkeypatch.setattr(
            module, 'run_evaluate_metrics',
            lambda results_dir, config_file, b, d, o, rundir, device=None,
            ran=ran: (ran.append((b, d)), (b, d, o, 1))[1])
        args = ['--results_dir', str(tmp_path / 'results'), '--config_file',
                str(cfg), '--output', str(tmp_path / f'{name}.csv'),
                '--rundir', str(tmp_path / f'{name}_rundir'),
                '--benchmarks', 'minibude']
        if name == 'jax':
            res = jax_cli(module.main, args)
            assert res.exit_code == 0, res.output
        else:
            assert module.main(args) == 0
        assert sorted(ran) == [('minibude', 'gaps'), ('minibude', 'tails')]
        frames.append(pd.read_csv(tmp_path / f'{name}.csv'))
    pd.testing.assert_frame_equal(frames[0], frames[1])
    assert (frames[1]['method'] == 'FAILED').all()


# ---------------------------------------------------------------------------
# plotting: the figures each function draws, port against JAX
# ---------------------------------------------------------------------------
def long_rows():
    """A long table of two cells, two methods and two sources, with gaps
    (NaN values, a row without its method)."""
    rng = np.random.default_rng(3)
    rows = []
    for bench, dset in (('b1', 'tails'), ('b2', 'gaps')):
        for method in ('ensemble', 'mve'):
            for source in ('s1', 's2'):
                for trial in (2, 0, 1):
                    rows.append({'trial': trial, 'benchmark': bench,
                                 'dataset': dset, 'method': method,
                                 'source': source,
                                 'sensitivity': float(rng.uniform()),
                                 'ue_time': float(rng.uniform()),
                                 'ue_dist': float(rng.uniform())})
    rows[1]['sensitivity'] = float('nan')
    rows[5]['ue_time'] = float('nan')
    rows[7]['method'] = float('nan')
    return rows


def record_figures(monkeypatch):
    """Replace ``Figure.savefig`` by a recorder of what each figure shows:
    its file name, title, lines, scatter points and bars."""
    from matplotlib.figure import Figure
    seen = {}

    def savefig(fig, path, *args, **kwargs):
        ax = fig.axes[0]
        seen[os.path.basename(str(path))] = {
            'title': ax.get_title(),
            'lines': [(l.get_label(), np.asarray(l.get_xydata(),
                                                 float).tolist())
                      for l in ax.get_lines()],
            'points': [np.asarray(c.get_offsets(), float).tolist()
                       for c in ax.collections],
            'bars': [(p.get_label(), p.get_height()) for p in ax.patches],
            'labels': (ax.get_xlabel(), ax.get_ylabel())}
    monkeypatch.setattr(Figure, 'savefig', savefig)
    return seen


PLOTS = {
    'trial_lines': (('sensitivity',), {}),
    'trial_lines_named': (('sensitivity',), {'name': 'trial_sensitivity'}),
    'scatter_with_r': ((), {'x': 'ue_dist', 'y': 'sensitivity'}),
    'series_bars_max': (('sensitivity',), {}),
    'series_bars_median': (('ue_time',), {'statistic': 'median'}),
    'bars_at_best': ((), {'select_by': 'sensitivity', 'show': 'ue_time'}),
    'absent_column': (('wasserstein_distance',), {}),
}


@pytest.mark.parametrize('case', sorted(PLOTS))
def test_plotting_draws_what_jax_draws(jax_scripts, monkeypatch, tmp_path,
                                       case):
    args, kwargs = PLOTS[case]
    function = case.replace('_named', '').replace('_max', '') \
        .replace('_median', '').replace('absent_column', 'series_bars')
    rows = long_rows()
    drawn = []
    for module, table in ((jax_scripts['plotting'], pd.DataFrame(rows)),
                          (plotting, rows)):
        seen = record_figures(monkeypatch)
        getattr(module, function)(table, *args, outdir=str(tmp_path),
                                  **kwargs)
        drawn.append(seen)
    assert drawn[1] == drawn[0]
    assert bool(drawn[1]) == (case != 'absent_column')


def test_plotting_without_matplotlib_names_it(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    with pytest.raises(ImportError, match='matplotlib.*--no_plots'):
        plotting.trial_lines(long_rows(), 'sensitivity', str(tmp_path))
    assert not os.listdir(tmp_path)
