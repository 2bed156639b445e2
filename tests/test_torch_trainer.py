"""The port's Trainer against the JAX package's on the same converted init,
on the CPU: every trainable family through the kernel path, the per-step
path and a tail batch (tolerances and their reasons:
tests/torch_trainer_parity.py)."""
import numpy as np
import pytest

from torch_trainer_parity import (LOOSE, TIGHT, assert_params_close,
                                  column, fit_both, rows)


@pytest.mark.parametrize('family', ['ensemble', 'ensemble_per_member',
                                    'mve', 'kde', 'mc_dropout'])
def test_trainer_matches_jax(tmp_path, family):
    jm, jt, pm, pt = fit_both(tmp_path, family)
    # KDE's epoch 0 runs step by step in both (its fit hook reads the
    # batches), then hands over to the kernel
    assert pt.fused_epochs_used == jt.fused_epochs_used == \
        (2 if family == 'kde' else 3)
    rj, rp = rows(jt), rows(pt)
    assert [(r['epoch'], r['step']) for r in rp] == \
        [(r['epoch'], r['step']) for r in rj]
    tol = LOOSE if family == 'kde' else TIGHT
    np.testing.assert_allclose(column(rp, 'train_loss'),
                               column(rj, 'train_loss'), **tol)
    if family != 'mc_dropout':
        np.testing.assert_allclose(column(rp, 'val_loss'),
                                   column(rj, 'val_loss'), **LOOSE)
        assert_params_close(jm, pm)
    if family == 'kde':
        np.testing.assert_array_equal(pm.kde.data.numpy(),
                                      np.asarray(jm.kde.data))
        assert pm.kde.data.device == pm.device


def test_per_step_path_matches_jax_scan_path(tmp_path):
    jm, jt, pm, pt = fit_both(tmp_path, 'ensemble',
                               cfg={'fused_epochs': False})
    assert pt.fused_epochs_used == jt.fused_epochs_used == 0
    rj, rp = rows(jt), rows(pt)
    np.testing.assert_allclose(column(rp, 'train_loss'),
                               column(rj, 'train_loss'), **LOOSE)
    np.testing.assert_allclose(column(rp, 'val_loss'),
                               column(rj, 'val_loss'), **LOOSE)
    assert_params_close(jm, pm)


def test_tail_batch_trains_step_by_step(tmp_path):
    """``drop_last=False`` with 100 rows: five full batches and a 4-row
    tail each epoch, so every epoch runs step by step in both packages."""
    jm, jt, pm, pt = fit_both(tmp_path, 'ensemble', n=100, drop_last=False)
    assert pt.fused_epochs_used == jt.fused_epochs_used == 0
    rj, rp = rows(jt), rows(pt)
    assert len(column(rp, 'train_loss')) == 3 * 7
    np.testing.assert_allclose(column(rp, 'train_loss'),
                               column(rj, 'train_loss'), **LOOSE)
    np.testing.assert_allclose(column(rp, 'val_loss'),
                               column(rj, 'val_loss'), **LOOSE)
    assert_params_close(jm, pm)
