"""Sharded training in the port against the JAX package's ``Trainer(mesh=)``
(tests/conftest.py's 8 virtual CPU devices, meshes of the same axis
sizes) and against the port's unsharded per-step fit, on the same
converted init, ``shuffle=False`` and ``drop_last=True`` (the shuffle
streams differ by design, tests/torch_trainer_parity.py).

One gloo world of 4 CPU ranks (module-scoped) runs every fit of this file
in its ranks (tests/torch_parallel_cases.py); the test functions read
what they returned and what rank 0 wrote.

Dropout and Δ-UQ's anchored batches draw from each package's own streams,
so the MC-dropout and Δ-UQ fits are held to the port unsharded only (the
same masks and anchors on every rank, from the global batch).

Tolerances are JAX's own for its sharded fits (tests/test_sharding.py:
``val_loss`` rel 1e-3, predictions 1e-4) on the nets without BatchNorm.
With BatchNorm the Linear biases that it cancels have a gradient of pure
rounding noise, on which Adam walks by up to the learning rate a step in
either package, sharded or not; their running means follow. So BatchNorm
nets are held as tests/torch_trainer_parity.py holds the unsharded
trainer: ``val_loss`` and the per-step training losses (training mode:
the biases cancel exactly) within 1e-3, each parameter's change over the
fit within 1e-6 of JAX's, the cancelled biases' within 1.5e-2, running
means 2e-2 and variances 5e-3.
"""
import csv
import os

import numpy as np
import pytest

from nnueehcs_tpu import model_builder as jmb
from nnueehcs_tpu import training as jtr
from nnueehcs_tpu_torch import training as ptr
from nnueehcs_tpu_torch.parallel import launch
from nnueehcs_tpu_torch.training.checkpoint import FORMAT, build_from_bundle

import torch_parallel_cases as cases
from test_torch_driver import (FILES, method_dir, mini_config,  # noqa: F401
                               with_trials)
from torch_parity import one_torch_thread  # noqa: F401
from torch_parity import descr, randomize_params, randomize_state
from torch_trainer_parity import BS, LOOSE, assert_params_close, data

pytestmark = pytest.mark.usefixtures('one_torch_thread')

CFG = {'accelerator': 'cpu', 'max_epochs': 3, 'gradient_clip_val': 5.0,
       'fused_epochs': False, 'log_every_n_steps': 1}
TOL_PRED = {'rtol': 0, 'atol': 1e-4}


def _jax(kind, layers, members=None, **tc):
    tc = {'loss': 'l1_loss', **tc}
    if kind == 'mlp':
        m = jmb.MLPModelBuilder(layers, train_config=tc).build()
    elif kind == 'mc_dropout':
        m = jmb.MCDropoutModelBuilder(layers, {'num_samples': 4,
                                               'dropout_percent': 0.2},
                                      train_config=tc).build()
    elif kind == 'delta_uq':
        m = jmb.DeltaUQMLPModelBuilder(layers, {'num_anchors': 4},
                                       train_config=tc).build()
    else:
        m = jmb.EnsembleModelBuilder(layers, {'num_models': members},
                                     train_config=tc).build()
    m.params = randomize_params(m.params, 1)
    m.state = randomize_state(m.state, 2)
    m.invalidate_cache()
    m.params_before_fit = [{k: np.array(v) for k, v in p.items()}
                           for p in m.params]
    return m


#: name -> (JAX model factory, mesh axes, BatchNorm in the net, held to
#: JAX's sharded fit as well as to the port's unsharded one)
CASES = {
    'mlp_bn_dp4': (lambda: _jax('mlp', descr()), {'dp': 4}, True, True),
    'mlp_dp4': (lambda: _jax('mlp', descr(bn=False)), {'dp': 4}, False,
                True),
    'ensemble_joint_dp2_member2': (
        lambda: _jax('ensemble', descr(bn=False), members=4),
        {'dp': 2, 'member': 2}, False, True),
    'ensemble_member2_tp2': (
        lambda: _jax('ensemble', descr(width=16, bn=False), members=2),
        {'member': 2, 'tp': 2}, False, True),
    'ensemble_bn_per_member_dp2_tp2': (
        lambda: _jax('ensemble', descr(width=16), members=2,
                     ensemble_loss='per_member'),
        {'dp': 2, 'tp': 2}, True, True),
    'mc_dropout_dp4': (lambda: _jax('mc_dropout', descr(hidden=3, bn=False)),
                       {'dp': 4}, False, False),
    'delta_uq_dp2_tp2': (lambda: _jax('delta_uq', descr(width=16, bn=False)),
                         {'dp': 2, 'tp': 2}, False, False),
}


def _bundle(m):
    return {'format': FORMAT, 'config': m.config_dict(),
            'arrays': m.arrays_dict()}


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """Each case's JAX model before its fit, and rank answers."""
    x, y = data()
    log_dir = str(tmp_path_factory.mktemp('sharded_fits'))
    models = {name: case[0]() for name, case in CASES.items()}
    run = [(name, _bundle(models[name]), dict(CFG, mesh=case[1]), x, y, BS,
            False) for name, case in CASES.items()]
    answers = launch(cases.train_cases, 4, threads=1, all_ranks=True,
                     timeout=cases.WORLD_TIMEOUT, args=(run, log_dir))
    return models, answers, tmp_path_factory.mktemp('reference_fits')


def _column(log_dir, key):
    with open(os.path.join(log_dir, 'metrics.csv')) as f:
        return np.array([float(r[key]) for r in csv.DictReader(f)
                         if r.get(key)])


@pytest.mark.parametrize('name', sorted(CASES))
def test_sharded_fit_matches_jax_sharded_and_port_unsharded(world, name):
    models, answers, tmp = world
    jm, (_, axes, bn, with_jax) = models[name], CASES[name]
    got = answers[0][name]
    x, y = data()
    # the port unsharded, from the same init (before JAX's fit moves it)
    pm, pt = cases.fit(_bundle(jm), CFG, x, y, BS, str(tmp), name)
    refs = [pt.callback_metrics['val_loss']]
    if with_jax:
        jt = jtr.Trainer('t', dict(CFG, mesh=axes),
                         callbacks=[jtr.EarlyStopping(patience=100)],
                         log_dir=str(tmp), version=f'{name}_jax')
        jt.fit(jm, jtr.DataLoader(jtr.ArrayDataset(x, y), BS, shuffle=False,
                                  drop_last=True),
               jtr.DataLoader(jtr.ArrayDataset(x, y), BS))
        refs.append(jt.callback_metrics['val_loss'])
    for ref in refs:
        assert got['val_loss'] == pytest.approx(ref, rel=1e-3)
    np.testing.assert_allclose(_column(got['log_dir'], 'train_loss'),
                               _column(pt.logger.log_dir, 'train_loss'),
                               **LOOSE)
    sharded = build_from_bundle({'format': FORMAT,
                                 'config': pm.config_dict(),
                                 'arrays': got['arrays']}, device='cpu')
    if bn:
        assert_params_close(jm, sharded)
        return
    pred = got['pred'] if isinstance(got['pred'], tuple) else (got['pred'],)
    if with_jax:
        want = jm(x, return_ue=True) if len(pred) == 2 else (jm(x),)
        for a, b in zip(pred, want):
            np.testing.assert_allclose(a, np.asarray(b), **TOL_PRED)
    unsharded = pm(x, return_ue=True) if len(pred) == 2 else (pm(x),)
    for a, b in zip(pred, unsharded):
        np.testing.assert_allclose(a, b.numpy(), **TOL_PRED)


@pytest.mark.parametrize('name', sorted(CASES))
def test_every_rank_ends_alike_and_rank_0_writes(world, name):
    """Every rank stops on the same epoch with the same validation loss
    and the same gathered weights; rank 0 writes the logs and the bundle,
    which holds every member whole and loads."""
    _, answers, _ = world
    first = answers[0][name]
    for other in (a[name] for a in answers[1:]):
        assert other['val_loss'] == first['val_loss']
        for a, b in zip(other['arrays']['params'], first['arrays']['params']):
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])
        np.testing.assert_array_equal(np.asarray(other['pred']),
                                      np.asarray(first['pred']))
    assert {'hparams.yaml', 'metrics.csv', 'model.pth'} <= set(
        first['files'])
    model = ptr.load_model(os.path.join(first['log_dir'], 'model.pth'),
                           device='cpu')
    for a, b in zip(model.arrays_dict()['params'],
                    first['arrays']['params']):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def test_all_ones_mesh_trains_through_the_training_kernel(tmp_path):
    """``{'dp': 1}`` is one device: the port trains it through kernel 3
    (its plain epoch here), where the JAX trainer turns its kernel off
    under any mesh; the fit is the unsharded kernel fit exactly."""
    jm = _jax('ensemble', descr(), members=2)
    x, y = data()
    cfg = dict(CFG, fused_epochs='force')
    m1, t1 = cases.fit(_bundle(jm), cfg, x, y, BS, str(tmp_path), 'plain')
    m2, t2 = cases.fit(_bundle(jm), dict(cfg, mesh={'dp': 1}), x, y, BS,
                       str(tmp_path), 'mesh')
    assert t2.mesh.is_trivial
    assert t1.fused_epochs_used == t2.fused_epochs_used == CFG['max_epochs']
    assert t2.callback_metrics['val_loss'] == t1.callback_metrics['val_loss']
    for a, b in zip(m1.arrays_dict()['params'], m2.arrays_dict()['params']):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def test_a_batch_smaller_than_dp_is_refused(tmp_path):
    from nnueehcs_tpu_torch.parallel.mesh import Mesh
    jm = _jax('mlp', descr(bn=False))
    x, y = data()
    tr = ptr.Trainer('t', CFG, log_dir=str(tmp_path), device='cpu')
    tr.mesh = Mesh({'dp': 4}, 0, 'cpu', {}, 'gloo')
    with pytest.raises(ValueError, match="batch size 2 is smaller"):
        tr.fit(build_from_bundle(_bundle(jm), device='cpu'),
               ptr.DataLoader(ptr.ArrayDataset(x, y), 2, drop_last=True))


def test_bo_cell_on_two_cpu_ranks_is_the_one_device_cell(mini_config,
                                                         tmp_path,
                                                         monkeypatch):
    """``run_bo_experiment(devices=)`` of two devices: one rank a device,
    rank 0 owning the BO client and the results tree, the trial trained
    on a dp mesh and evaluated sharded over it. The tree and the trial
    are the one-device run's (the net has no BatchNorm: the dp fit is the
    unsharded fit to round-off); timed columns aside."""
    from nnueehcs_tpu_torch import driver
    # the ranks inherit it: one thread each beside the other test workers
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    cfg = with_trials(mini_config, 1)
    one = driver.run_bo_experiment('minibude', 'ensemble', cfg, 'tails',
                                   str(tmp_path / 'one'), device='cpu')
    two = driver.run_bo_experiment('minibude', 'ensemble', cfg, 'tails',
                                   str(tmp_path / 'two'),
                                   devices=['cpu', 'cpu'])
    trial = os.path.join(method_dir(str(tmp_path / 'two')), 'bo_trial_0')
    assert set(FILES) <= set(os.listdir(trial))
    assert sorted(one) == sorted(two) == [0]
    a, b = one[0], two[0]
    for key in ('learning_rate', 'batch_size', 'weight_decay', 'num_models',
                'failed', 'platform'):
        assert a[key] == b[key], key
    for key in ('id_loss', 'ood_loss', 'id_ue', 'ood_ue', 'percentile_score'):
        assert b[key] == pytest.approx(a[key], rel=1e-4, abs=1e-6), key


def test_mesh_workflow_slices_of_several_cards_run_sharded(monkeypatch):
    from nnueehcs_tpu_torch.examples.bo_driven import mesh_workflow_driver
    calls = []

    def fake_run(bench, method, config, dset, output, restart, **where):
        calls.append(where)
    monkeypatch.setattr(mesh_workflow_driver, 'run_bo_experiment', fake_run)
    slices = [['cuda:0', 'cuda:1'], ['cuda:2']]
    cells = [('minibude', 'ensemble', 'tails'), ('minibude', 'ensemble',
                                                 'gaps')]
    results = mesh_workflow_driver.run_cells(cells, {}, 'out', slices)
    assert [r[3] for r in results] == ['OK', 'OK']
    assert sorted(map(str, calls)) == sorted(map(str, [
        {'devices': ['cuda:0', 'cuda:1']}, {'device': 'cuda:2'}]))
