"""The port's BO driver (``nnueehcs_tpu_torch/driver.py``) against the JAX
package's, on ``tests/test_driver.py``'s fixture (minibude at 1,200 rows,
2 epochs, 2 trials, the CPU): the same files and ``trial_results.csv``
columns, restart (and restart of a complete run as a no-op), each
package resuming the other's results tree, the same metric values from
``evaluate`` on one bundle and one dataset, and the command line, which
runs on the CPU only when asked.

Whole trial rows are not compared: the port's trainer shuffles with a
``torch.Generator``, so its fits see other batches than the JAX
trainer's."""
import copy
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from nnueehcs_tpu import driver as jax_driver
from nnueehcs_tpu.data_utils import get_dataset as jax_get_dataset
from nnueehcs_tpu.data_utils import prepare_dataset_for_use as jax_prepare
from nnueehcs_tpu.evaluation import get_uncertainty_evaluator as jax_metrics
from nnueehcs_tpu.training import load_model as jax_load_model
from nnueehcs_tpu_torch import datagen, driver
from nnueehcs_tpu_torch.data_utils import get_dataset, prepare_dataset_for_use
from nnueehcs_tpu_torch.evaluation import (RuntimeEvaluation,
                                           get_uncertainty_evaluator)
from nnueehcs_tpu_torch.training import load_model

from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

FILES = ('ax_client.json', 'ax_client_optimization_step.json',
         'trial_results.csv', 'model.pth', 'metrics.csv')
TOL = 1e-5


def method_dir(out):
    return os.path.join(out, 'minibude', 'tails', 'ensemble')


@pytest.fixture(scope='module')
def mini_config(tmp_path_factory):
    """``tests/test_driver.py``'s fixture, its data written by the port."""
    tmp = tmp_path_factory.mktemp('data')
    ipt, opt = datagen.generate_minibude(1200)
    path = str(tmp / 'bude.h5')
    datagen.write_hdf5(path, ipt, opt, 'BUDEKernel')
    arch = [{'Linear': {'args': [6, 16]}}, {'ReLU': {}},
            {'Linear': {'args': [16, 1]}}]
    datasets = {}
    for split, percs in [('tails_id', '[0, 70]'), ('tails_ood', '[70, 100]'),
                         ('gaps_id', '[0, 30], [60, 100]'),
                         ('gaps_ood', '[30, 60]')]:
        datasets[split] = {'format': 'hdf5', 'path': path,
                           'group_name': 'BUDEKernel',
                           'input_dataset': 'input',
                           'output_dataset': 'output',
                           'percentiles': percs, 'dtype': 'float32'}
    return {
        'trainer': {'accelerator': 'cpu', 'max_epochs': 2,
                    'log_every_n_steps': 5, 'gradient_clip_val': 5},
        'training': {
            'loss': 'l1_loss', 'scaling': True, 'validation_split': 0.2,
            'parameter_space': [
                {'name': 'learning_rate', 'type': 'fixed', 'value': 1e-3},
                {'name': 'weight_decay', 'type': 'fixed', 'value': 0},
                {'name': 'batch_size', 'type': 'fixed', 'value': 128},
            ]},
        'benchmarks': {'minibude': {'model': {'architecture': arch},
                                    'datasets': datasets}},
        'uq_methods': {'ensemble': {'parameter_space': [
            {'name': 'num_models', 'type': 'range', 'bounds': [2, 4]},
        ]}},
        'bo_config': {'trials': 2, 'max_failures': 1,
                      'evaluation_metric': [
                          {'name': 'percentile_score', 'percentile': 95},
                          {'name': 'uncertainty_estimating_throughput'},
                      ]},
    }


def with_trials(config, trials):
    config = copy.deepcopy(config)
    config['bo_config']['trials'] = trials
    return config


@pytest.fixture(scope='module')
def jax_tree(mini_config, tmp_path_factory):
    out = str(tmp_path_factory.mktemp('jax') / 'results')
    jax_driver.run_bo_experiment('minibude', 'ensemble', mini_config, 'tails',
                                 out)
    return out


@pytest.fixture(scope='module')
def port_tree(mini_config, tmp_path_factory):
    """The port's run through its command line: the config (trainer
    ``accelerator: auto``) as a YAML file, ``--device cpu``."""
    tmp = tmp_path_factory.mktemp('port')
    config = copy.deepcopy(mini_config)
    config['trainer']['accelerator'] = 'auto'
    path = tmp / 'config.yaml'
    path.write_text(yaml.safe_dump(config))
    out = str(tmp / 'results')
    args = ['--benchmark', 'minibude', '--uq_method', 'ensemble',
            '--config', str(path), '--dataset', 'tails', '--output', out,
            '--device', 'cpu']
    assert driver.main(args) == 0
    return out, args


def test_port_run_writes_the_jax_files_and_columns(jax_tree, port_tree):
    out, _ = port_tree
    assert sorted(os.listdir(method_dir(out))) == \
        sorted(os.listdir(method_dir(jax_tree))) == ['bo_trial_0',
                                                     'bo_trial_1']
    for trial in ('bo_trial_0', 'bo_trial_1'):
        ours = sorted(os.listdir(os.path.join(method_dir(out), trial)))
        theirs = sorted(os.listdir(os.path.join(method_dir(jax_tree),
                                                trial)))
        assert ours == theirs
        assert set(FILES) <= set(ours)
    last = 'bo_trial_1'
    assert os.path.isfile(os.path.join(method_dir(out), last,
                                       'pareto_parameters.json'))
    ours = pd.read_csv(os.path.join(method_dir(out), last,
                                    'trial_results.csv'))
    theirs = pd.read_csv(os.path.join(method_dir(jax_tree), last,
                                      'trial_results.csv'))
    assert list(ours.columns) == list(theirs.columns)
    assert list(ours['trial']) == list(theirs['trial']) == [0, 1]
    assert list(ours['num_models']) == list(theirs['num_models'])
    assert not ours['failed'].any()
    assert set(ours['platform']) == {'cpu'}
    assert (ours['uncertainty_estimating_throughput'] > 0).all()
    for col in ('learning_rate', 'batch_size', 'weight_decay'):
        assert list(ours[col]) == list(theirs[col])


def test_trial_results_read_in_pandas_as_the_jax_file_reads(tmp_path):
    """pandas reads the port's ``trial_results.csv`` as it reads the JAX
    driver's (pandas' ``to_csv``) for the same rows."""
    rows = {0: {'a': 0.1 + 0.2, 'b': np.float32(1 / 3), 'c': float('nan'),
                'd': True, 'e': 'x,y', 'f': 7, 'g': np.float64(1e-300),
                'u': np.float32(0.30294412), 'n': 3},
            1: {'a': -2.5e17, 'h': None, 'u': np.float32(2.5), 'd': False,
                'e': '', 'n': 4},
            2: {'a': 1.0, 'u': float('nan'), 'f': 3, 'n': 5}}
    frames = []
    for pkg, name in ((driver, 'ours'), (jax_driver, 'theirs')):
        manager = pkg.OutputManager(str(tmp_path / name), 'minibude',
                                    append_benchmark_name=False)
        manager.save_trial_results_dict(rows)
        frames.append(pd.read_csv(tmp_path / name / 'trial_results.csv'))
    pd.testing.assert_frame_equal(*frames)


def test_restart_resumes_and_a_complete_run_restarts_as_a_no_op(
        port_tree, tmp_path):
    out, args = port_tree
    copy_out = str(tmp_path / 'results')
    shutil.copytree(out, copy_out)
    before = {f: os.stat(os.path.join(method_dir(copy_out), 'bo_trial_1',
                                      f)).st_mtime_ns for f in FILES}
    config_path = args[args.index('--config') + 1]
    with open(config_path) as f:
        config = yaml.safe_load(f)
    results = driver.run_bo_experiment('minibude', 'ensemble',
                                       with_trials(config, 3), 'tails',
                                       copy_out, restart=True, device='cpu')
    assert sorted(results) == [0, 1, 2]
    assert sorted(os.listdir(method_dir(copy_out))) == [
        'bo_trial_0', 'bo_trial_1', 'bo_trial_2']
    assert before == {f: os.stat(os.path.join(
        method_dir(copy_out), 'bo_trial_1', f)).st_mtime_ns for f in FILES}
    table = pd.read_csv(os.path.join(method_dir(copy_out), 'bo_trial_2',
                                     'trial_results.csv'))
    assert list(table['trial']) == [0, 1, 2] and not table['failed'].any()
    # the quota is met: restarting runs no trial and keeps the results
    again = driver.run_bo_experiment('minibude', 'ensemble',
                                     with_trials(config, 3), 'tails',
                                     copy_out, restart=True, device='cpu')
    assert sorted(again) == [0, 1, 2]
    assert sorted(os.listdir(method_dir(copy_out))) == [
        'bo_trial_0', 'bo_trial_1', 'bo_trial_2']
    assert os.path.isfile(os.path.join(method_dir(copy_out), 'bo_trial_2',
                                       'pareto_parameters.json'))


def test_each_package_reads_the_others_restart_state(jax_tree, port_tree):
    out, _ = port_tree
    for reader, tree in ((jax_driver.get_restart, out),
                         (driver.get_restart, jax_tree)):
        index, client, rows = reader(tree, 'minibude', 'tails', 'ensemble')
        assert index == 2
        assert [t['status'] for t in client.trials] == ['completed'] * 2
        assert sorted(rows) == [0, 1]
        assert all(str(r['failed']) == 'False' for r in rows.values())


@pytest.mark.parametrize('resumer', ['port', 'jax'])
def test_each_package_resumes_the_others_tree(mini_config, jax_tree,
                                              port_tree, tmp_path, resumer):
    source = jax_tree if resumer == 'port' else port_tree[0]
    tree = str(tmp_path / 'results')
    shutil.copytree(source, tree)
    run = driver.run_bo_experiment if resumer == 'port' \
        else jax_driver.run_bo_experiment
    results = run('minibude', 'ensemble', with_trials(mini_config, 3),
                  'tails', tree, restart=True)
    assert sorted(results) == [0, 1, 2]
    table = pd.read_csv(os.path.join(method_dir(tree), 'bo_trial_2',
                                     'trial_results.csv'))
    assert list(table['trial']) == [0, 1, 2] and not table['failed'].any()
    # the third trial's parameters: the same Sobol point in both packages
    other = pd.read_csv(os.path.join(method_dir(source), 'bo_trial_1',
                                     'trial_results.csv'))
    assert list(table['num_models'][:2]) == list(other['num_models'])


def test_evaluate_gives_the_jax_metric_values(mini_config, jax_tree):
    """Both packages' ``evaluate`` on the JAX run's first bundle and the
    same scaled data."""
    bundle = os.path.join(method_dir(jax_tree), 'bo_trial_0', 'model.pth')
    datasets = mini_config['benchmarks']['minibude']['datasets']
    training = mini_config['training']
    metrics = mini_config['bo_config']['evaluation_metric']
    results = []
    for get, prepare, load, evaluate, factory in (
            (get_dataset, prepare_dataset_for_use,
             lambda p: load_model(p, device='cpu'), driver.evaluate,
             get_uncertainty_evaluator),
            (jax_get_dataset, jax_prepare, jax_load_model,
             jax_driver.evaluate, jax_metrics)):
        dset_id = get(datasets, 'tails')
        dset_ood = prepare(get(datasets, 'tails', is_ood=True), training,
                           scaling_dset=dset_id)
        dset_id = prepare(dset_id, training)
        results.append(evaluate(load(bundle), dset_id, dset_ood,
                                factory(metrics), warmup=1, trials=2))
    ours, theirs = results
    for key in ('id_loss', 'ood_loss'):
        assert abs(ours[key] - theirs[key]) <= TOL * max(1, abs(theirs[key]))
    for key in ('id_ue', 'ood_ue'):
        assert np.abs(ours[key].data - np.asarray(theirs[key].data)).max() \
            <= TOL
    for key in ('ue_time', 'id_time', 'ood_time'):
        assert len(ours[key]) == len(theirs[key]) == 2
        assert all(t > 0 for t in ours[key])
    evaluators = get_uncertainty_evaluator(metrics).metrics
    for metric, a, b in zip(evaluators, ours['metric_results'],
                            theirs['metric_results']):
        assert sorted(a) == sorted(b)
        for key in a:
            if isinstance(metric, RuntimeEvaluation):
                assert a[key] > 0
            else:
                assert abs(a[key] - b[key]) <= TOL * max(1, abs(b[key]))


def test_the_card_is_the_default_and_no_fallback(port_tree, tmp_path,
                                                 monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    _, args = port_tree
    out = str(tmp_path / 'nowhere')
    args = list(args)
    args[args.index('--output') + 1] = out
    with pytest.raises(RuntimeError, match='cuda'):
        driver.main(args[:-2])                  # without --device cpu
    assert not os.path.exists(out)
    with pytest.raises(RuntimeError, match='cuda'):
        driver.run_bo_experiment('minibude', 'ensemble', {}, 'tails', out,
                                 devices=['cuda:0', 'cuda:1'])
    assert not os.path.exists(out)
