"""Δ-UQ and PAGER training in the port against the JAX package, on the CPU:
the anchored gather of the kernel epochs, the anchor hooks, validation over
``val_num_anchors`` anchors, and whole fits in fp32 and bf16-mixed.

The port draws its anchor permutations from its own ``torch.Generator``
stream (a deliberate difference, ROADMAP §3); here the port's trainer is fed
JAX's draws instead (``Trainer.anchor_permutations``, computed from the JAX
trainer's ``fold_in`` keys through numpy), so both packages anchor every
batch alike and the fits compare. Fits run ``shuffle=False`` and
``whole_fit: False`` with the JAX kernel in interpret mode
(``tests/torch_trainer_parity.py``): epoch 0 step by step while the hook
captures the anchors, then kernel epochs on the doubled batch.

Bars: the gather bit for bit (the same rows, permuted and subtracted in
fp32); validation 1e-5 (the anchored means through kernel 5's plain
version and through JAX's module walk, fp32 round-off); fp32 fits as the
fp32 parity tests hold a fit whose epoch 0 runs step by step (KDE's: LOOSE
losses, each parameter's change 1e-6, BatchNorm-cancelled biases 1.5e-2);
bf16 fits as ``tests/test_torch_trainer_bf16.py`` holds its per-step fits
(the first loss TIGHT, then within twice the largest bf16-vs-fp32 gap of
JAX's own curves), with parameters within its bars."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnueehcs_tpu import training as jtr
from nnueehcs_tpu.ops import fused_train as ft
from nnueehcs_tpu.training import hooks as jhooks
from nnueehcs_tpu_torch import training as ptr
from nnueehcs_tpu_torch.ops import fused_train as pt
from nnueehcs_tpu_torch.training import hooks as phooks

from test_torch_trainer_bf16 import _assert_changes_close, _within_gap
from torch_parity import descr, jax_anchored, port_of
from torch_trainer_parity import (BS, LOOSE, TIGHT, assert_params_close,
                                  column, data, rows)

SEED = 42                      # both trainers' default seed


def jax_permutations(epoch_rng, first_step, steps, batch):
    """``(steps, 2, batch)``: the permutations JAX anchors steps
    ``first_step ..`` of an epoch with, from its keys: per step
    ``fold_in(epoch_rng, step)``, then ``fold_in(., 0)`` and ``(., 1)``."""
    out = []
    for s in range(first_step, first_step + steps):
        rng = jax.random.fold_in(epoch_rng, s)
        out.append([np.asarray(jax.random.permutation(
            jax.random.fold_in(rng, j), batch)) for j in (0, 1)])
    return torch.tensor(np.array(out), dtype=torch.int64)


def jax_trainer_permutations(seed=SEED):
    """A ``Trainer.anchor_permutations`` that returns the JAX trainer's
    draws (its train key is the third of ``split(PRNGKey(seed), 4)``)."""
    train_key = jax.random.split(jax.random.PRNGKey(seed), 4)[2]

    def perms(epoch, first_step, steps, batch):
        return jax_permutations(jax.random.fold_in(train_key, epoch),
                                first_step, steps, batch)
    return perms


def test_anchored_gather_matches_jax_on_its_permutations():
    x, y = data(n=64)
    jm = jax_anchored(descr())
    plan = ft.plan_fused_train(jm.net, 1, 2 * BS, member_stacked=False)
    pplan = pt.plan_fused_train(port_of(jm).net, 1, 2 * BS,
                                member_stacked=False)
    idx = np.random.default_rng(1).permutation(64).astype(np.int32)
    epoch_rng = jax.random.fold_in(jax.random.PRNGKey(3), 2)
    want = ft.gather_anchored_epoch_batches(plan, jnp.asarray(x),
                                            jnp.asarray(y), jnp.asarray(idx),
                                            epoch_rng)
    perms = jax_permutations(epoch_rng, 0, 64 // BS, BS)
    got = pt.gather_anchored_epoch_batches(
        pplan, torch.from_numpy(x), torch.from_numpy(y),
        torch.from_numpy(idx.astype(np.int64)), perms)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the port's own stream: permutations, one pair a step
    gen = torch.Generator().manual_seed(0)
    own = pt.anchor_permutations(gen, 5, BS)
    assert own.shape == (5, 2, BS)
    assert torch.equal(own.sort(dim=-1).values,
                       torch.arange(BS).expand(5, 2, BS))


@pytest.mark.parametrize('kind', ['delta_uq', 'pager'])
def test_anchor_hooks_capture_as_jax(kind):
    """Epoch-0 batches in, the first ``num_anchors`` inputs (and for PAGER
    their targets) installed at the first validation; later epochs change
    nothing."""
    x, y = data(n=48)
    jm = jax_anchored(descr(), kind=kind, num_anchors=20)
    pm = port_of(jm)
    jm.anchors = None
    pm.anchors = None
    cls = 'DeltaUQGetAnchorsHook' if kind == 'delta_uq' else \
        'PAGERGetAnchorsHook'
    for hook, model in ((getattr(jhooks, cls)(), jm),
                        (getattr(phooks, cls)(), pm)):
        assert type(model.get_callbacks()[0]).__name__ == cls
        assert not hook.fusion_quiescent(0)
        for b in range(3):
            hook.on_train_batch_end(None, model, (x[b * 16:(b + 1) * 16],
                                                  y[b * 16:(b + 1) * 16]), b)
        hook.on_validation_epoch_start(None, model)
        assert hook.fusion_quiescent(1)
        hook.on_train_batch_end(None, model, (x[:16] + 1, y[:16]), 0)
        hook.on_validation_epoch_start(None, model)
    np.testing.assert_array_equal(pm.anchors.numpy(), np.asarray(jm.anchors))
    np.testing.assert_array_equal(pm.anchors.numpy(), x[:20])
    if kind == 'pager':
        np.testing.assert_array_equal(pm.anchors_Y.numpy(),
                                      np.asarray(jm.anchors_Y))


@pytest.mark.parametrize('kind', ['delta_uq', 'pager'])
@pytest.mark.parametrize('val_num_anchors', [None, 3])
def test_validation_loss_over_val_num_anchors(kind, val_num_anchors):
    jm = jax_anchored(descr(), kind=kind, num_anchors=7,
                      val_num_anchors=val_num_anchors)
    pm = port_of(jm)
    assert pm.val_num_anchors == val_num_anchors
    x, y = data(n=40)
    want = float(jm.validation_loss(jm.params, jm.state,
                                    (jnp.asarray(x), jnp.asarray(y)), None))
    got = float(pm.validation_loss((torch.from_numpy(x),
                                    torch.from_numpy(y))))
    assert abs(got - want) <= 1e-5
    with torch.no_grad():
        full = float(pm.loss(pm.eval_output(torch.from_numpy(x)),
                             torch.from_numpy(y)))
    assert (abs(full - got) < 1e-7) == (val_num_anchors is None)


def _fit_both(tmp_path, kind, cfg):
    x, y = data()
    jm = jax_anchored(descr(), kind=kind, num_anchors=20)
    jm.anchors = None
    if kind == 'pager':
        jm.anchors_Y = None
    jm.params_before_fit = [{k: np.array(v) for k, v in p.items()}
                            for p in jm.params]
    pm = port_of(jm)
    config = {'accelerator': 'cpu', 'max_epochs': 3, 'gradient_clip_val': 5.0,
              'fused_epochs': 'force', 'whole_fit': False,
              'log_every_n_steps': 1, **cfg}
    jt = jtr.Trainer('t', config, callbacks=jm.get_callbacks(),
                     log_dir=str(tmp_path), version='jax')
    jt.fit(jm, jtr.DataLoader(jtr.ArrayDataset(x, y), BS, shuffle=False,
                              drop_last=True),
           jtr.DataLoader(jtr.ArrayDataset(x, y), BS))
    trainer = ptr.Trainer('t', config, callbacks=pm.get_callbacks(),
                          log_dir=str(tmp_path), version='port',
                          device='cpu')
    trainer.anchor_permutations = jax_trainer_permutations()
    trainer.fit(pm, ptr.DataLoader(ptr.ArrayDataset(x, y), BS, shuffle=False,
                                   drop_last=True),
                ptr.DataLoader(ptr.ArrayDataset(x, y), BS))
    return jm, jt, pm, trainer


@pytest.mark.parametrize('kind', ['delta_uq', 'pager'])
def test_fp32_fit_matches_jax(tmp_path, kind):
    jm, jt, pm, ptr_ = _fit_both(tmp_path, kind, {})
    assert ptr_.fused_epochs_used == jt.fused_epochs_used == 2
    np.testing.assert_array_equal(pm.anchors.numpy(), np.asarray(jm.anchors))
    rj, rp = rows(jt), rows(ptr_)
    np.testing.assert_allclose(column(rp, 'train_loss')[:6],
                               column(rj, 'train_loss')[:6], **TIGHT)
    np.testing.assert_allclose(column(rp, 'train_loss'),
                               column(rj, 'train_loss'), **LOOSE)
    np.testing.assert_allclose(column(rp, 'val_loss'),
                               column(rj, 'val_loss'), **LOOSE)
    assert_params_close(jm, pm)


@pytest.mark.parametrize('kind', ['delta_uq', 'pager'])
def test_bf16_fit_matches_jax(tmp_path, kind):
    jm, jt, pm, ptr_ = _fit_both(tmp_path / 'bf16', kind,
                                 {'precision': 'bf16-mixed'})
    _, jt32, _, _ = _fit_both(tmp_path / 'fp32', kind, {})
    assert ptr_.fused_epochs_used == jt.fused_epochs_used == 2
    assert pm.train_config['precision'] == 'bf16-mixed'
    got, want, want32 = (column(rows(t), 'train_loss')
                         for t in (ptr_, jt, jt32))
    np.testing.assert_allclose(got[:1], want[:1], **TIGHT)
    _within_gap(got, want, want32)
    _within_gap(*(column(rows(t), 'val_loss') for t in (ptr_, jt, jt32)))
    _assert_changes_close(jm, pm, jm.params_before_fit)
