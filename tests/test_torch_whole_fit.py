"""Whole-fit dispatch in the port's Trainer, on the CPU: every remaining
epoch of a kernel fit enqueued at once, with the plateau schedule, early
stopping and the best pin kept as tensors (``training/whole_fit.py``).

Against the port's own per-epoch kernel path (``fused_epochs: 'force'``,
the plain epoch here) from the same seeded model, for every family that
trains the kernel, in fp32 and bf16-mixed: the parameters, the BatchNorm
state, every logged step loss, the stop epoch and the pinned best bundle
and the validation losses bit for bit (both paths take the float64
mean of the same batch losses through one reduction,
``training/whole_fit.py`` ``weighted_mean``). Against the JAX package's
whole-fit (``whole_fit: True``, its kernel in interpret mode, the
set-up of ``tests/torch_trainer_parity.py``) within the bars that file
holds the per-epoch kernel path to.
"""
import os

import numpy as np
import pytest
import torch

from nnueehcs_tpu_torch import model_builder as pmb
from nnueehcs_tpu_torch import training as ptr
from nnueehcs_tpu_torch.convert import tensor_trees
from nnueehcs_tpu_torch.ops import fused_train as pft
from nnueehcs_tpu_torch.training import trainer as ptrainer
from nnueehcs_tpu_torch.training.whole_fit import weighted_mean

from torch_parity import descr, one_torch_thread  # noqa: F401 (fixture)
from torch_trainer_parity import (LOOSE, TIGHT, assert_params_close, column,
                                  data, fit_both, rows)

pytestmark = pytest.mark.usefixtures('one_torch_thread')

N, BS = 96, 16
FAMILIES = ('ensemble', 'mc_dropout', 'mve', 'kde', 'delta_uq', 'pager')
# epoch 0 of these runs step by step (their hooks read its batches)
PER_STEP_FIRST = ('kde', 'delta_uq', 'pager')


def port_model(family, seed=0, lr=1e-3, hidden=2):
    arch = descr(width=16, hidden=hidden)
    tc = {'loss': 'l1_loss', 'learning_rate': lr}
    kw = dict(train_config=tc, seed=seed, device='cpu')
    if family == 'ensemble':
        return pmb.EnsembleModelBuilder(arch, {'num_models': 2}, **kw).build()
    if family == 'mc_dropout':
        return pmb.MCDropoutModelBuilder(
            descr(width=16, hidden=3),
            {'num_samples': 4, 'dropout_percent': 0.2}, **kw).build()
    if family == 'mve':
        return pmb.MVEModelBuilder(arch, {'min_variance': 1e-6}, **kw).build()
    if family == 'kde':
        return pmb.KDEModelBuilder(arch, {'rtol': 1000}, **kw).build()
    builder = pmb.DeltaUQMLPModelBuilder if family == 'delta_uq' \
        else pmb.PAGERModelBuilder
    return builder(arch, {'num_anchors': 8}, **kw).build()


def port_fit(tmp_path, family, whole, version, epochs=4, precision=None,
             patience=100, min_delta=0.0, lr=1e-3, cfg=None, hidden=2):
    """A port fit of ``family`` with EarlyStopping and a deferred
    ModelSavingCallback; returns (model, trainer, saver, metrics rows)."""
    x, y = data(N)
    model = port_model(family, lr=lr, hidden=hidden)
    saver = ptr.ModelSavingCallback(defer_serialization=True)
    config = {'max_epochs': epochs, 'gradient_clip_val': 5.0, 'seed': 7,
              'fused_epochs': 'force', 'whole_fit': whole,
              'log_every_n_steps': 1, **(cfg or {})}
    if precision:
        config['precision'] = precision
    trainer = ptr.Trainer(
        't', config, callbacks=[ptr.EarlyStopping(patience=patience,
                                                  min_delta=min_delta),
                                saver] + model.get_callbacks(),
        log_dir=str(tmp_path), version=version, device='cpu')
    trainer.fit(model, ptr.DataLoader(ptr.ArrayDataset(x, y), BS,
                                      shuffle=True, drop_last=True),
                ptr.DataLoader(ptr.ArrayDataset(x, y), BS))
    return model, trainer, saver, rows(trainer)


def assert_same_fit(a, b):
    """Two port fits equal: parameters and state, the logged step losses,
    the stop epoch, the pinned best and the val losses."""
    (ma, ta, sa, ra), (mb, tb, sb, rb) = a, b
    for (k, va), (_, vb) in zip(ma.net.state_dict().items(),
                                mb.net.state_dict().items()):
        assert torch.equal(va, vb), k
    assert [(r['epoch'], r['step'], r['train_loss']) for r in ra] == \
        [(r['epoch'], r['step'], r['train_loss']) for r in rb]
    np.testing.assert_array_equal(column(ra, 'val_loss'),
                                  column(rb, 'val_loss'))
    assert ta.current_epoch == tb.current_epoch
    assert ta.should_stop == tb.should_stop
    assert ta.fused_epochs_used == tb.fused_epochs_used
    assert sa.best == sb.best
    for (k, va), (_, vb) in zip(sa._pinned.items(), sb._pinned.items()):
        assert torch.equal(va, vb), k


@pytest.mark.parametrize('precision', [None, 'bf16-mixed'],
                         ids=['fp32', 'bf16'])
@pytest.mark.parametrize('family', FAMILIES)
def test_whole_fit_equals_per_epoch_kernel_path(tmp_path, family, precision):
    whole = port_fit(tmp_path, family, True, 'w', precision=precision)
    per_epoch = port_fit(tmp_path, family, False, 'e', precision=precision)
    first = 1 if family in PER_STEP_FIRST else 0
    assert whole[1].whole_fit_dispatches == 1
    assert per_epoch[1].whole_fit_dispatches == 0
    assert whole[1].fused_epochs_used == 4 - first
    assert whole[1].whole_fit_epochs_lost == 0
    assert_same_fit(whole, per_epoch)


def test_early_stop_on_the_card_state(tmp_path):
    """A min_delta no epoch can beat: patience 1 stops after epoch 1 on the
    device exactly as on the host path; later epochs change nothing."""
    whole = port_fit(tmp_path, 'ensemble', True, 'w', epochs=12, patience=1,
                     min_delta=1e6)
    per_epoch = port_fit(tmp_path, 'ensemble', False, 'e', epochs=12,
                         patience=1, min_delta=1e6)
    assert len(column(whole[3], 'val_loss')) == 2
    assert whole[1].current_epoch == 1 and whole[1].should_stop
    assert_same_fit(whole, per_epoch)


def test_epochs_enqueued_past_the_stop_change_nothing(tmp_path,
                                                      monkeypatch):
    """With a poll that never sees the flag (a card that has not caught
    up), every epoch to max_epochs is enqueued: those after the stop leave
    the buffers, the decisions and the step count alone, and are counted
    as lost."""
    monkeypatch.setattr(ptrainer.StopPoll, 'stopped', lambda self: False)
    whole = port_fit(tmp_path, 'ensemble', True, 'w', epochs=8, patience=1,
                     min_delta=1e6)
    per_epoch = port_fit(tmp_path, 'ensemble', False, 'e', epochs=8,
                         patience=1, min_delta=1e6)
    assert whole[1].whole_fit_epochs_lost == 6
    assert_same_fit(whole, per_epoch)


def test_stopped_epoch_leaves_every_buffer(tmp_path):
    """``fused_epoch(stop=1)`` returns at once; ``stop=0`` and a device
    learning rate train exactly as the host's number does."""
    model = port_model('ensemble')
    plan = pft.plan_fused_train(model.net, 2, BS, clip=5.0)
    x, y = data(N)
    xs, ys = pft.gather_epoch_batches(plan, torch.from_numpy(x),
                                      torch.from_numpy(y), torch.arange(N))
    p_tree, s_tree = tensor_trees(model.net)
    bufs = [pft.pack_tree(plan, p_tree), torch.zeros(plan.total_rows, 128),
            torch.zeros(plan.total_rows, 128), pft.pack_state(plan, s_tree)]
    before = [b.clone() for b in bufs]
    pft.fused_epoch(plan, *bufs, xs, ys, 1e-3, 0,
                    stop=torch.ones(1, dtype=torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(bufs, before))
    host = [b.clone() for b in before]
    _, _, _, _, l_host = pft.fused_epoch(plan, *host, xs, ys, 1e-3, 0)
    _, _, _, _, l_dev = pft.fused_epoch(
        plan, *bufs, xs, ys, torch.tensor([1e-3], dtype=torch.float32), 0,
        stop=torch.zeros(1, dtype=torch.int32))
    assert torch.equal(l_host, l_dev)
    assert all(torch.equal(a, b) for a, b in zip(bufs, host))
    with pytest.raises(ValueError, match='stop'):
        pft.fused_epoch(plan, *bufs, xs, ys, 1e-3, 0,
                        stop=torch.ones(1, dtype=torch.int64))


def test_plateau_scales_the_learning_rate_on_the_card_state(tmp_path,
                                                            monkeypatch):
    """At lr 1e-9 no epoch improves the validation loss by the plateau's
    threshold: after epoch 0 sets the best, epochs 1-11 are bad, the scale
    drops after epoch 11 and epochs 12-13 train at 0.1x, the same learning
    rates (as float32) on both paths. One Linear layer: BatchNorm's running
    statistics would move the validation loss at any learning rate."""
    seen = []
    real = pft.fused_epoch

    def spy(plan, theta, m, v, sigma, xs, ys, lr, *args, **kwargs):
        seen.append(float(np.float32(float(lr.reshape(())) if isinstance(
            lr, torch.Tensor) else lr)))
        return real(plan, theta, m, v, sigma, xs, ys, lr, *args, **kwargs)

    monkeypatch.setattr(pft, 'fused_epoch', spy)
    whole = port_fit(tmp_path, 'ensemble', True, 'w', epochs=14, lr=1e-9,
                     hidden=0)
    lr_whole, seen[:] = list(seen), []
    per_epoch = port_fit(tmp_path, 'ensemble', False, 'e', epochs=14,
                         lr=1e-9, hidden=0)
    f32 = lambda v: float(np.float32(v))
    assert lr_whole == seen == [f32(1e-9)] * 12 + [f32(1e-9 * 0.1)] * 2
    assert_same_fit(whole, per_epoch)


def test_best_pin_reloads_as_the_per_epoch_bundle(tmp_path):
    """The deferred ModelSavingCallback sees the pinned parameters at the
    argmin epoch only: the bundle the whole fit writes reloads to the
    per-epoch fit's, and serves its answers."""
    whole = port_fit(tmp_path, 'ensemble', True, 'w', epochs=6)
    per_epoch = port_fit(tmp_path, 'ensemble', False, 'e', epochs=6)
    assert_same_fit(whole, per_epoch)
    vls = column(whole[3], 'val_loss')
    assert whole[2].best == vls.min()
    loaded = [ptr.load_model(os.path.join(t.logger.log_dir, 'model.pth'),
                             device='cpu') for t in (whole[1], per_epoch[1])]
    for (k, va), (_, vb) in zip(loaded[0].net.state_dict().items(),
                                loaded[1].net.state_dict().items()):
        assert torch.equal(va, vb), k
    x = torch.from_numpy(data(8, seed=1)[0])
    assert torch.equal(loaded[0](x), loaded[1](x))


def test_auto_rule_at_the_ports_constants(tmp_path):
    """``'auto'`` at the port's constants: a dispatch's set-up is under one
    epoch's saving on the card, so there is no break-even and no survival
    delay (JAX's pay for its compile), and a fit engages whenever it is
    eligible, from its first kernel epoch, with or without EarlyStopping
    and however few epochs remain; the fit is the per-epoch one."""
    x, y = data(N)
    bare = ptr.Trainer('t', {'max_epochs': 3, 'fused_epochs': 'force',
                             'seed': 7}, callbacks=[],
                       log_dir=str(tmp_path), device='cpu')
    bare.fit(port_model('ensemble'), ptr.DataLoader(
        ptr.ArrayDataset(x, y), BS, shuffle=True, drop_last=True))
    assert bare.whole_fit_dispatches == 1 and bare.fused_epochs_used == 3
    for epochs in (1, 2, 5):
        auto = port_fit(tmp_path, 'ensemble', 'auto', f'a{epochs}',
                        epochs=epochs)
        assert auto[1].whole_fit_dispatches == 1
        assert auto[1].fused_epochs_used == epochs
        assert_same_fit(auto, port_fit(tmp_path, 'ensemble', False,
                                       f'e{epochs}', epochs=epochs))
    anchored = port_fit(tmp_path, 'delta_uq', 'auto', 'd', epochs=2)
    assert anchored[1].whole_fit_dispatches == 1
    assert anchored[1].fused_epochs_used == 1


@pytest.mark.parametrize('hooks', ['two_early_stops', 'other_validation_hook',
                                   'max_mode'])
def test_hooks_that_cannot_be_replayed_keep_the_per_epoch_path(tmp_path,
                                                               hooks):
    """JAX's eligibility rules: at most one EarlyStopping, on val_loss in
    'min' mode, and no other hook acting at validation end."""
    class Watch(ptr.TrainerHook):
        def on_validation_end(self, trainer, model, metrics):
            pass

    extra = {'two_early_stops': [ptr.EarlyStopping(patience=50)],
             'other_validation_hook': [Watch()],
             'max_mode': [ptr.EarlyStopping(mode='max', patience=50)]}[hooks]
    x, y = data(N)
    model = port_model('ensemble')
    callbacks = extra if hooks == 'max_mode' else \
        [ptr.EarlyStopping(patience=50)] + extra
    trainer = ptr.Trainer('t', {'max_epochs': 3, 'fused_epochs': 'force',
                                'whole_fit': True}, callbacks=callbacks,
                          log_dir=str(tmp_path), device='cpu')
    trainer.fit(model, ptr.DataLoader(ptr.ArrayDataset(x, y), BS,
                                      drop_last=True))
    assert trainer.whole_fit_dispatches == 0
    assert trainer.fused_epochs_used == 3


def test_a_failed_dispatch_raises(tmp_path, monkeypatch):
    """A failure inside the dispatch ends the fit: the port does not fall
    back to per-epoch kernels (a failed CUDA launch leaves the context
    unusable), and ``whole_fit: False`` never enters the dispatch."""
    real = pft.fused_epoch

    def broken(*args, stop=None, **kwargs):
        if stop is not None:
            raise RuntimeError('fused training kernel launch failed')
        return real(*args, **kwargs)

    monkeypatch.setattr(pft, 'fused_epoch', broken)
    with pytest.raises(RuntimeError, match='launch failed'):
        port_fit(tmp_path, 'ensemble', True, 'w')
    fine = port_fit(tmp_path, 'ensemble', False, 'e')
    assert fine[1].fused_epochs_used == 4


def test_trivial_mesh_runs_the_whole_fit(tmp_path):
    """A mesh of one rank is one device: it keeps the kernel and the
    whole-fit dispatch, with the same fit."""
    cfg = {'mesh': {'dp': 1}, 'devices': ['cpu'], 'accelerator': 'cpu'}
    meshed = port_fit(tmp_path, 'ensemble', True, 'm', cfg=cfg)
    assert meshed[1].mesh is not None and meshed[1].mesh.is_trivial
    assert meshed[1].whole_fit_dispatches == 1
    assert_same_fit(meshed, port_fit(tmp_path, 'ensemble', False, 'e'))


@pytest.mark.parametrize('n', [1, 2, 7, 8, 9, 16, 100, 127, 128, 129, 300,
                               1000, 8193])
def test_weighted_mean_is_numpys_average(n, tmp_path):
    """The one reduction of both paths: numpy's weighted average of the
    float64 losses up to the order of the sum (within 1e-14 relative), and
    ``Trainer._weighted_val``, the per-epoch path's value, bit for bit."""
    rng = np.random.default_rng(n)
    losses = (rng.random(n) * 10.0 ** rng.integers(-6, 6, n)).astype(
        np.float32)
    sizes = [16] * (n - 1) + [int(rng.integers(1, 17))]
    weights = torch.tensor(sizes, dtype=torch.float64)
    got = weighted_mean(torch.from_numpy(losses), weights)
    assert got.dtype == torch.float64 and got.shape == ()
    want = np.average(losses.astype(np.float64), weights=sizes)
    assert abs(float(got) - want) <= 1e-14 * abs(want)

    class Losses:                # validation batch b's loss is losses[b]
        net = torch.nn.Module()

        def validation_loss(self, batch, seed):
            return torch.tensor(losses[int(batch[0][0])])
    rows = sum(sizes)
    x_val = torch.repeat_interleave(torch.arange(n), torch.tensor(sizes))
    trainer = ptr.Trainer('t', {}, callbacks=[], log_dir=str(tmp_path),
                          device='cpu')
    assert trainer._weighted_val(Losses(), x_val[:, None].float(),
                                 torch.zeros(rows), 16, n, 0) == float(got)


@pytest.mark.parametrize('family', ['ensemble', 'mve', 'kde'])
def test_whole_fit_matches_jax_whole_fit(tmp_path, family):
    """Both packages' whole-fit dispatch from the same converted init,
    held as the per-epoch kernel paths are (``tests/test_torch_trainer.py``):
    KDE's epoch 0 runs step by step in both, then one dispatch."""
    jm, jt, pm, pt = fit_both(tmp_path, family, cfg={'whole_fit': True,
                                                     'max_epochs': 4})
    assert jt.whole_fit_dispatches == pt.whole_fit_dispatches == 1
    assert pt.fused_epochs_used == jt.fused_epochs_used == \
        (3 if family == 'kde' else 4)
    rj, rp = rows(jt), rows(pt)
    assert [(r['epoch'], r['step']) for r in rp] == \
        [(r['epoch'], r['step']) for r in rj]
    np.testing.assert_allclose(column(rp, 'train_loss'),
                               column(rj, 'train_loss'),
                               **(LOOSE if family == 'kde' else TIGHT))
    np.testing.assert_allclose(column(rp, 'val_loss'),
                               column(rj, 'val_loss'), **LOOSE)
    assert_params_close(jm, pm)


def test_anchored_whole_fit_matches_jax_whole_fit(tmp_path):
    """Δ-UQ: epoch 0 step by step while the hook captures the anchors, then
    one dispatch in both packages, the port fed JAX's anchor draws
    (``tests/test_torch_trainer_anchored.py``)."""
    from test_torch_trainer_anchored import _fit_both
    jm, jt, pm, pt = _fit_both(tmp_path, 'delta_uq', {'whole_fit': True,
                                                      'max_epochs': 4})
    assert jt.whole_fit_dispatches == pt.whole_fit_dispatches == 1
    assert pt.fused_epochs_used == jt.fused_epochs_used == 3
    rj, rp = rows(jt), rows(pt)
    np.testing.assert_allclose(column(rp, 'train_loss')[:6],
                               column(rj, 'train_loss')[:6], **TIGHT)
    np.testing.assert_allclose(column(rp, 'train_loss'),
                               column(rj, 'train_loss'), **LOOSE)
    np.testing.assert_allclose(column(rp, 'val_loss'),
                               column(rj, 'val_loss'), **LOOSE)
    assert_params_close(jm, pm)
