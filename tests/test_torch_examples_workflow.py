"""The port's BO entry point and workflow drivers
(``nnueehcs_tpu_torch/examples/bo_driven/{bo,workflow_driver,
mesh_workflow_driver}.py``) against the JAX scripts, on
``tests/test_workflow.py``'s fixture (minibude at 800 rows, a 6-8-1 net,
the ensemble with 2-3 members, 1 trial of 1 epoch a cell): ``bo`` writes
the JAX script's files and ``trial_results.csv`` columns; the grid runs as
restartable subprocesses with ``--device cpu``; the sbatch scripts carry
the JAX script's ``#SBATCH`` lines; the slice driver runs its cells on 2
CPU slices; the cell filters refuse what the JAX scripts refuse."""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pandas as pd
import pytest
import torch
import yaml
from click.testing import CliRunner

from nnueehcs_tpu_torch import datagen
from nnueehcs_tpu_torch.examples.bo_driven import (bo, mesh_workflow_driver,
                                                   workflow_driver)

from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

REPO = Path(__file__).resolve().parents[1]
JAX_BO = REPO / 'examples' / 'bo_driven'
TRIAL_FILES = ('trial_results.csv', 'ax_client.json',
               'ax_client_optimization_step.json', 'metrics.csv',
               'model.pth')


@pytest.fixture(scope='module')
def grid_config(tmp_path_factory):
    """tests/test_workflow.py's config, its data written by the port's
    ``datagen``, the trainer on ``accelerator: auto`` (the card unless a
    ``--device`` says otherwise)."""
    tmp = tmp_path_factory.mktemp('wf')
    ipt, opt = datagen.generate_minibude(800)
    path = str(tmp / 'bude.h5')
    datagen.write_hdf5(path, ipt, opt, 'BUDEKernel')
    arch = [{'Linear': {'args': [6, 8]}}, {'ReLU': {}},
            {'Linear': {'args': [8, 1]}}]
    datasets = {s: {'format': 'hdf5', 'path': path, 'group_name': 'BUDEKernel',
                    'input_dataset': 'input', 'output_dataset': 'output',
                    'percentiles': p, 'dtype': 'float32'}
                for s, p in [('tails_id', '[0, 70]'),
                             ('tails_ood', '[70, 100]'),
                             ('gaps_id', '[0, 30], [60, 100]'),
                             ('gaps_ood', '[30, 60]')]}
    cfg = {
        'trainer': {'accelerator': 'auto', 'max_epochs': 1,
                    'gradient_clip_val': 5},
        'training': {'loss': 'l1_loss', 'scaling': True,
                     'validation_split': 0.2,
                     'parameter_space': [
                         {'name': 'learning_rate', 'type': 'fixed',
                          'value': 1e-3},
                         {'name': 'weight_decay', 'type': 'fixed', 'value': 0},
                         {'name': 'batch_size', 'type': 'fixed',
                          'value': 128}]},
        'benchmarks': {'minibude': {'model': {'architecture': arch},
                                    'datasets': datasets}},
        'uq_methods': {'ensemble': {'parameter_space': [
            {'name': 'num_models', 'type': 'range', 'bounds': [2, 3]}]}},
        'bo_config': {'trials': 1, 'max_failures': 1, 'evaluation_metric': [
            {'name': 'percentile_score', 'percentile': 95},
            {'name': 'uncertainty_estimating_throughput'}]},
        'evaluation': {'metrics': [
            {'name': 'percentile_classification', 'threshold': 0.9,
             'reversed': False},
            {'name': 'auroc'},
        ]},
        'workflow_config': {'max_concurrent_tasks': 2, 'retries': 1},
        'bo_slurm_config': {'partition': 'pbatch', 'walltime': '1:00:00',
                            'account': 'uq'},
    }
    cfg_path = tmp / 'config.yaml'
    cfg_path.write_text(yaml.safe_dump(cfg))
    return str(cfg_path), tmp, cfg


def trial_dir(out, dset='tails'):
    return Path(out) / 'minibude' / dset / 'ensemble' / 'bo_trial_0'


def test_bo_writes_the_jax_scripts_files_and_columns(grid_config, tmp_path,
                                                     monkeypatch):
    """The same command line through both scripts: the same files and
    ``trial_results.csv`` columns (trial rows differ: the two trainers
    shuffle with other generators). The port's also drops the inherited
    SLURM CPU-binding variables, as the JAX script does."""
    cfg_path, _, cfg = grid_config
    jax_cfg = tmp_path / 'jax.yaml'
    jax_cfg.write_text(yaml.safe_dump(
        dict(cfg, trainer=dict(cfg['trainer'], accelerator='cpu'))))
    spec = importlib.util.spec_from_file_location('jax_bo_script',
                                                  JAX_BO / 'bo.py')
    jax_bo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_bo)
    args = ['--benchmark', 'minibude', '--uq_method', 'ensemble',
            '--dataset', 'tails']
    res = CliRunner().invoke(jax_bo.main, args + [
        '--config', str(jax_cfg), '--output', str(tmp_path / 'jax'),
        '--platform', 'cpu'])
    assert res.exit_code == 0, res.output
    monkeypatch.setenv('SLURM_CPU_BIND', 'quiet')
    assert bo.main(args + ['--config', cfg_path, '--output',
                           str(tmp_path / 'port'), '--device', 'cpu']) == 0
    assert 'SLURM_CPU_BIND' not in os.environ
    jax_dir, port_dir = (trial_dir(tmp_path / n) for n in ('jax', 'port'))
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    assert list(pd.read_csv(port_dir / 'trial_results.csv').columns) == \
        list(pd.read_csv(jax_dir / 'trial_results.csv').columns)


def test_bo_refuses_the_cpu_unless_asked(grid_config, tmp_path, monkeypatch):
    cfg_path, _, _ = grid_config
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='cuda'):
        bo.main(['--benchmark', 'minibude', '--uq_method', 'ensemble',
                 '--dataset', 'tails', '--config', cfg_path, '--output',
                 str(tmp_path / 'out')])


def test_workflow_driver_runs_the_grid_on_the_cpu(grid_config, tmp_path):
    """Both split cells as restartable subprocesses of the port's ``bo``,
    with the JAX test's on-disk contract, then a rerun that restarts each
    complete cell as a no-op."""
    cfg_path, _, _ = grid_config
    out, rundir = str(tmp_path / 'results'), str(tmp_path / 'rundir')
    env = dict(os.environ, OMP_NUM_THREADS='1', PYTHONPATH=str(REPO))
    command = [sys.executable, '-m',
               'nnueehcs_tpu_torch.examples.bo_driven.workflow_driver',
               '--config', cfg_path, '--output', out, '--rundir', rundir,
               '--device', 'cpu']
    for _ in range(2):
        proc = subprocess.run(command, capture_output=True, text=True,
                              timeout=600, cwd=str(tmp_path), env=env)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert 'minibude/ensemble/tails: OK' in proc.stdout
    for dset in ('tails', 'gaps'):
        for name in TRIAL_FILES:
            assert (trial_dir(out, dset) / name).is_file(), (dset, name)
        log = Path(rundir) / f'minibude_ensemble_{dset}.out'
        assert log.read_text().count('--- attempt 0') == 2
        assert pd.read_csv(trial_dir(out, dset) / 'trial_results.csv')[
            'platform'].tolist() == ['cpu']


def test_workflow_driver_failed_cell_is_retried_then_reported(
        grid_config, tmp_path, monkeypatch):
    """A cell that fails is retried ``retries`` times with a doubling
    wait, then reported with its exit code."""
    cfg_path, _, _ = grid_config
    waits = []
    monkeypatch.setattr(workflow_driver.time, 'sleep', waits.append)
    result = workflow_driver.run_bo_task(
        cfg_path, 'minibude', 'ensemble', 'tails', str(tmp_path / 'out'),
        str(tmp_path / 'rundir'), retries=2, device='no-such-device')
    assert result[:3] == ('minibude', 'ensemble', 'tails') and result[3] != 0
    assert waits == [30, 60]
    log = (tmp_path / 'rundir' / 'minibude_ensemble_tails.out').read_text()
    assert [f'--- attempt {k}' in log for k in range(3)] == [True] * 3


def sbatch_lines(directory):
    return {p.name: [line for line in p.read_text().splitlines()
                     if line.startswith('#')]
            for p in Path(directory).glob('*.sbatch')}


@pytest.mark.parametrize('cells', [None, 'minibude:ensemble:gaps'],
                         ids=['grid', 'cells'])
def test_sbatch_scripts_carry_the_jax_lines(grid_config, tmp_path, cells):
    cfg_path, _, _ = grid_config
    extra = ['--cells', cells] if cells else []
    proc = subprocess.run(
        [sys.executable, str(JAX_BO / 'workflow_driver.py'), '--config',
         cfg_path, '--output', 'r', '--rundir', str(tmp_path / 'jax'),
         '--sbatch', *extra], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert workflow_driver.main(['--config', cfg_path, '--output', 'r',
                                 '--rundir', str(tmp_path / 'port'),
                                 '--sbatch', *extra]) == 0
    port, jax = sbatch_lines(tmp_path / 'port'), sbatch_lines(tmp_path / 'jax')
    assert port == jax and len(port) == (1 if cells else 2)
    body = next((tmp_path / 'port').glob('*.sbatch')).read_text()
    assert '-m nnueehcs_tpu_torch.examples.bo_driven.bo' in body
    assert '--restart' in body
    assert '#SBATCH --partition=pbatch' in body


BAD_CELLS = ['minibude:ensemble', 'nope:ensemble:tails',
             'minibude:pager:tails', 'minibude:ensemble:middle']


@pytest.mark.parametrize('cell', BAD_CELLS)
def test_bad_cells_are_refused_as_by_jax(grid_config, tmp_path, cell):
    cfg_path, _, _ = grid_config
    proc = subprocess.run(
        [sys.executable, str(JAX_BO / 'workflow_driver.py'), '--config',
         cfg_path, '--rundir', str(tmp_path), '--sbatch', '--cells', cell],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2, proc.stdout + proc.stderr
    for module in (workflow_driver, mesh_workflow_driver):
        with pytest.raises(SystemExit) as info:
            module.main(['--config', cfg_path, '--device', 'cpu',
                         '--cells', cell])
        assert info.value.code == 2
    assert not list(tmp_path.glob('*.sbatch'))


def test_mesh_workflow_driver_runs_cells_on_two_cpu_slices(grid_config,
                                                           tmp_path, capsys):
    cfg_path, _, _ = grid_config
    out = str(tmp_path / 'mesh')
    assert mesh_workflow_driver.main([
        '--config', cfg_path, '--output', out, '--slices', '2',
        '--retries', '0', '--device', 'cpu']) == 0
    printed = capsys.readouterr().out
    assert '2 slices of 1 device: cpu, cpu' in printed
    for dset in ('tails', 'gaps'):
        assert f'minibude/ensemble/{dset}: OK' in printed
        assert (trial_dir(out, dset) / 'trial_results.csv').is_file()


def test_mesh_slices_on_the_cpu_are_threads():
    assert mesh_workflow_driver.device_slices('cpu', 3) == [['cpu']] * 3
    assert mesh_workflow_driver.device_slices('cpu') == [['cpu']]


@pytest.mark.parametrize('cards,slices,want', [
    (4, None, [['cuda:0'], ['cuda:1'], ['cuda:2'], ['cuda:3']]),
    (4, 4, [['cuda:0'], ['cuda:1'], ['cuda:2'], ['cuda:3']]),
    (1, None, [['cuda:0']]),
    (4, 2, [['cuda:0', 'cuda:1'], ['cuda:2', 'cuda:3']]),
    (4, 1, [['cuda:0', 'cuda:1', 'cuda:2', 'cuda:3']]),
])
def test_mesh_slices_cut_the_cards_as_jax_does(monkeypatch, cards, slices,
                                               want):
    """The JAX driver gives each slice ``devices // slices`` devices, in
    order; a slice of several cards runs its trials sharded over them."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: cards)
    assert mesh_workflow_driver.device_slices('cuda', slices) == want


@pytest.mark.parametrize('cards,slices,error', [
    (4, 8, ValueError),         # the JAX driver cuts 8 down to 4 slices
    (4, 0, ValueError),
    (0, None, RuntimeError),    # CUDA present but no card visible
])
def test_mesh_slices_refuse_what_the_cards_cannot_give(monkeypatch, cards,
                                                       slices, error):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: cards)
    with pytest.raises(error, match='--slices' if error is ValueError
                       else 'no CUDA card'):
        mesh_workflow_driver.device_slices('cuda', slices)


def test_mesh_slices_need_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='cuda'):
        mesh_workflow_driver.device_slices('cuda')


def test_mesh_cells_share_slices_from_a_queue(grid_config, monkeypatch):
    """More cells than slices: every cell runs, no two at once on one
    slice, and each on a slice it leased."""
    import threading
    import time
    _, _, cfg = grid_config
    busy, seen, lock = set(), [], threading.Lock()

    def fake_run(bench, method, config, dset, output, restart, device):
        with lock:
            assert device not in busy
            busy.add(device)
            seen.append((dset, device))
        time.sleep(0.05)
        with lock:
            busy.discard(device)
    monkeypatch.setattr(mesh_workflow_driver, 'run_bo_experiment', fake_run)
    cells = [('minibude', 'ensemble', d) for d in ('tails', 'gaps') * 3]
    slices = ['cuda:0', 'cuda:1']
    results = mesh_workflow_driver.run_cells(cells, cfg, 'out', slices)
    assert [r[3] for r in results] == ['OK'] * 6
    assert len(seen) == 6 and {d for _, d in seen} <= set(slices)
