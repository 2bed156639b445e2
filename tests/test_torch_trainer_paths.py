"""The port's Trainer against the JAX package's, on the CPU: batch limits,
the kernel-to-step hand-off, early stopping and plateau decisions, the
files it writes, the weights it leaves for serving, the deferred
checkpoint and the cases it does not port (tolerances and their reasons:
tests/torch_trainer_parity.py)."""
import os

import numpy as np
import pytest
import torch
import yaml

from nnueehcs_tpu import training as jtr
from nnueehcs_tpu_torch import model_builder as pmb
from nnueehcs_tpu_torch import training as ptr

from torch_parity import descr
from torch_trainer_parity import (BS, LOOSE, TIGHT, N, assert_params_close,
                                  column, data, fit_both, rows)

@pytest.mark.parametrize('cfg', [
    {'overfit_batches': 2},
    {'limit_train_batches': 0.5, 'limit_val_batches': 2},
], ids=['overfit_batches', 'limits'])
def test_batch_limits_match_jax(tmp_path, cfg):
    """Lightning's batch limits pick the same batches in both trainers:
    ``overfit_batches`` trains and validates on the first batches,
    ``limit_*_batches`` take a fraction or a count."""
    jm, jt, pm, pt = fit_both(tmp_path, 'ensemble', cfg=cfg)
    assert pt.fused_epochs_used == jt.fused_epochs_used
    rj, rp = rows(jt), rows(pt)
    assert [(r['epoch'], r['step']) for r in rp] == \
        [(r['epoch'], r['step']) for r in rj]
    np.testing.assert_allclose(column(rp, 'train_loss'),
                               column(rj, 'train_loss'), **TIGHT)
    np.testing.assert_allclose(column(rp, 'val_loss'),
                               column(rj, 'val_loss'), **LOOSE)


def test_kernel_to_per_step_handoff_matches_jax(tmp_path):
    """A hook that asks for epoch 2's batches makes both trainers hand the
    kernel's parameters and Adam state back to the per-step path."""
    seen = {}

    def make(pkg, m):
        class LateBatchHook(pkg.TrainerHook):
            def on_train_batch_end(self, trainer, model, batch, batch_idx):
                seen.setdefault(pkg.__name__, []).append(
                    (trainer.current_epoch, batch_idx))

            def wants_train_batches(self, epoch):
                return epoch == 2
        return [pkg.EarlyStopping(patience=100), LateBatchHook()]

    jm, jt, pm, pt = fit_both(tmp_path, 'ensemble', cfg={'max_epochs': 4},
                               callbacks=make)
    assert pt.fused_epochs_used == jt.fused_epochs_used == 2
    assert seen['nnueehcs_tpu_torch.training'] == \
        seen['nnueehcs_tpu.training'] == [(2, b) for b in range(N // BS)]
    rj, rp = rows(jt), rows(pt)
    np.testing.assert_allclose(column(rp, 'train_loss'),
                               column(rj, 'train_loss'), **LOOSE)
    np.testing.assert_allclose(column(rp, 'val_loss'),
                               column(rj, 'val_loss'), **LOOSE)
    assert_params_close(jm, pm)


def test_early_stopping_and_plateau_decide_as_jax():
    metrics = [1.0, 0.9, 0.95, 0.9, 0.91, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.1,
               0.49995, 1.2, 1.3, 1.4]
    jp, pp = jtr.trainer.PlateauScheduler(patience=2), \
        ptr.PlateauScheduler(patience=2)
    assert [pp.step(v) for v in metrics] == [jp.step(v) for v in metrics]

    class T:
        should_stop = False
        current_epoch = 0

    for patience, min_delta in ((2, 0.0), (3, 0.05)):
        stops = []
        for pkg in (jtr, ptr):
            es, t = pkg.EarlyStopping(patience=patience, min_delta=min_delta), T()
            for epoch, v in enumerate(metrics):
                t.current_epoch = epoch
                es.on_validation_end(t, None, {'val_loss': v})
                if t.should_stop:
                    break
            stops.append((epoch, es.best_score, es.wait_count))
        assert stops[0] == stops[1]


def test_early_stopping_ends_the_fit(tmp_path):
    """Epoch 0 sets the best score and epochs 1 and 2 miss it by
    ``min_delta``, so the fit stops after epoch 2 (the decision itself is
    held to the JAX package's above)."""
    x, y = data()
    model = pmb.EnsembleModelBuilder(descr(), {'num_models': 2},
                                     device='cpu').build()
    tr = ptr.Trainer('t', {'max_epochs': 6, 'fused_epochs': 'force'},
                     callbacks=[ptr.EarlyStopping(patience=2, min_delta=10.0)],
                     log_dir=str(tmp_path), device='cpu')
    tr.fit(model, ptr.DataLoader(ptr.ArrayDataset(x, y), BS, drop_last=True))
    assert tr.should_stop and tr.current_epoch == 2
    assert len(column(rows(tr), 'val_loss')) == 3


def test_hparams_and_bundle_read_by_the_jax_package(tmp_path):
    # zero epochs: both trainers write their hparams.yaml and train nothing
    cfg = {'seed': 3, 'precision': '32-true', 'limit_val_batches': 2,
           'max_epochs': 0}
    jm, jt, pm, pt = fit_both(tmp_path, 'ensemble', cfg=cfg)
    load = lambda t: yaml.safe_load(open(os.path.join(t.logger.log_dir,
                                                      'hparams.yaml')))
    assert load(pt) == load(jt)
    x, y = data()
    tr = ptr.Trainer('t', dict(cfg, max_epochs=2, fused_epochs='force'),
                     callbacks=[ptr.ModelSavingCallback()],
                     log_dir=str(tmp_path), version='bundle', device='cpu')
    tr.fit(pm, ptr.DataLoader(ptr.ArrayDataset(x, y), BS, drop_last=True))
    path = os.path.join(tr.logger.log_dir, 'model.pth')
    jax_copy = jtr.load_model(path)
    x = np.random.default_rng(5).normal(size=(200, 5)).astype(np.float32)
    want = jax_copy(x, return_ue=True)
    got = ptr.load_model(path, device='cpu')(x, return_ue=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize('family', ['ensemble', 'mve'])
def test_model_after_fit_serves_its_latest_weights(tmp_path, family):
    """Validation folds the weights between kernel epochs; the trainer's
    write-back must bump the tensors' versions, or the model would keep
    serving the first fold."""
    x, y = data()
    builder = pmb.EnsembleModelBuilder(descr(), {'num_models': 2},
                                       device='cpu') \
        if family == 'ensemble' else pmb.MVEModelBuilder(descr(), {},
                                                         device='cpu')
    model = builder.build()
    tr = ptr.Trainer('t', {'max_epochs': 3, 'fused_epochs': 'force',
                           'gradient_clip_val': 5.0},
                     callbacks=[], log_dir=str(tmp_path), device='cpu')
    tr.fit(model, ptr.DataLoader(ptr.ArrayDataset(x, y), BS, drop_last=True))
    assert tr.fused_epochs_used == 3
    path = str(tmp_path / 'after.pth')
    ptr.save_model(model, path)
    fresh = ptr.load_model(path, device='cpu')
    for a, b in zip(model(x, return_ue=True), fresh(x, return_ue=True)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


def test_deferred_checkpoint_saves_the_best_epoch(tmp_path):
    x, y = data()
    model = pmb.EnsembleModelBuilder(descr(), {'num_models': 2},
                                     device='cpu').build()
    saver = ptr.ModelSavingCallback(defer_serialization=True)
    tr = ptr.Trainer('t', {'max_epochs': 3, 'fused_epochs': 'force'},
                     callbacks=[saver], log_dir=str(tmp_path), device='cpu')
    tr.fit(model, ptr.DataLoader(ptr.ArrayDataset(x, y), BS, drop_last=True))
    best = ptr.load_model(os.path.join(tr.logger.log_dir, 'model.pth'),
                          device='cpu')
    val = tr.validate(best, ptr.DataLoader(ptr.ArrayDataset(x, y), BS))
    assert abs(val - saver.best) < 1e-6
    assert saver.best == min(column(rows(tr), 'val_loss'))


def test_unported_cases_raise(tmp_path, monkeypatch):
    for key, value in (('mesh', 'auto'), ('devices', [0])):
        with pytest.raises(NotImplementedError, match=key):
            ptr.Trainer('t', {key: value}, log_dir=str(tmp_path),
                        device='cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='cuda'):
        ptr.Trainer('t', {}, log_dir=str(tmp_path))


def test_delta_uq_trains_through_the_kernel_after_its_anchor_epoch(tmp_path):
    """Δ-UQ trains (it was refused before its slice): epoch 0 step by step,
    its hook capturing the anchors, then kernel epochs on the doubled
    batch; validation scores the anchored mean."""
    x, y = data()
    dq = pmb.DeltaUQMLPModelBuilder(descr(), {'num_anchors': 4},
                                    device='cpu').build()
    tr = ptr.Trainer('t', {'max_epochs': 2, 'fused_epochs': 'force'},
                     callbacks=dq.get_callbacks(), log_dir=str(tmp_path),
                     device='cpu')
    tr.fit(dq, ptr.DataLoader(ptr.ArrayDataset(x, y), BS, drop_last=True))
    assert tr.fused_epochs_used == 1
    np.testing.assert_array_equal(dq.anchors.numpy(), x[:4])
    assert np.isfinite(column(rows(tr), 'train_loss')).all()
    assert np.isfinite(tr.callback_metrics['val_loss'])


def test_bf16_mixed_precision_trains(tmp_path):
    """A trainer precision of 'bf16-mixed' trains (it was refused before
    its slice): per-step on the CPU by default, the precision recorded on
    the model and in its train_config, the weights fp32."""
    x, y = data()
    tr = ptr.Trainer('t', {'max_epochs': 1, 'precision': 'bf16-mixed'},
                     callbacks=[], log_dir=str(tmp_path), device='cpu')
    model = pmb.MLPModelBuilder(descr(), device='cpu').build()
    tr.fit(model, ptr.DataLoader(ptr.ArrayDataset(x, y), BS))
    assert tr.fused_epochs_used == 0
    assert model.precision == model.train_config['precision'] == 'bf16-mixed'
    assert model.net.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.net.parameters())
    assert np.isfinite(tr.callback_metrics['val_loss'])
