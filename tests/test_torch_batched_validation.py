"""Batched validation on the CPU: the JAX trainer's scanned validation
(``get_val_scan``), ported as one evaluation of every full validation
batch (``validation_losses``, one launch of the model's kernel on the
card), against the per-batch losses it replaces and against the JAX
package.

- For every UQ class (MLP, ensemble, MVE, KDE, kNN-KDE, MC dropout, Δ-UQ,
  PAGER) and a CNN ensemble, ``validation_losses`` equals today's
  per-batch ``validation_loss``, stacked, within 1e-6 relative (the same
  rows through the same plain versions and modules; a batched reduction
  sums in another order), at 128 rows a batch, at 100 (not a multiple of
  the kernels' 64-row tile) and with a partial tail batch through
  ``Trainer._val_losses``.
- The batched losses match the JAX package's per-batch
  ``validation_loss`` on the same converted weights within 1e-5; MC
  dropout (the port's hash masks against ``jax.random``) within 3x the
  JAX package's own seed-to-seed spread at 4,096 samples, as
  tests/test_torch_mc_dropout.py holds it.
- ``dropout_scale`` with a seed table draws, bit for bit, the masks of the
  separate per-batch calls, at any row offset.
- A pass calls the model's kernel wrapper once for its full batches, and
  once more for a tail.

The kernels themselves (one launch against the per-batch launches, bit
for bit) are held on a card by tests/test_torch_cuda.py and
``chip_smoke.py``'s ``validation`` phase."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnueehcs_tpu import model_builder as jmb
from nnueehcs_tpu_torch import training as ptr
from nnueehcs_tpu_torch.models import delta_uq, ensemble, mc_dropout
from nnueehcs_tpu_torch.ops import fused_mc_dropout as mc

from test_torch_cnn_models import images, jax_cnn
from test_torch_density_models import jax_density
from torch_parity import one_torch_thread  # noqa: F401
from torch_parity import (descr, jax_anchored, jax_ensemble, jax_mc_dropout,
                          port_of, randomize_params, randomize_state)

pytestmark = pytest.mark.usefixtures('one_torch_thread')

REL = 1e-6                # batched against per-batch, relative
TOL_JAX = 1e-5            # against the JAX package, absolute and relative
STAT_FACTOR = 3.0         # MC dropout: x JAX's seed-to-seed spread
STAT_SAMPLES = 4096
KINDS = ('mlp', 'ensemble', 'mve', 'kde', 'knn_kde', 'mc_dropout',
         'delta_uq', 'pager', 'cnn_ensemble')
SHAPES = {'bs128': (3, 128), 'bs100': (3, 100)}


def jax_model(kind, num_samples=8):
    if kind == 'mlp':
        m = jmb.MLPModelBuilder(descr(), seed=0,
                                train_config={'loss': 'l1_loss'}).build()
        m.params = randomize_params(m.params, 1)
        m.state = randomize_state(m.state, 2)
        m.invalidate_cache()
        return m
    if kind == 'ensemble':
        return jax_ensemble(descr())
    if kind in ('mve', 'kde', 'knn_kde'):
        return jax_density(kind, **({'k': 7} if kind == 'knn_kde' else {}))
    if kind == 'mc_dropout':
        return jax_mc_dropout(descr(hidden=3), num_samples=num_samples,
                              p=0.2, seed=4)
    if kind in ('delta_uq', 'pager'):
        return jax_anchored(descr(), kind=kind, num_anchors=7)
    return jax_cnn('ensemble')


def batches(kind, nb, bs, seed=3):
    """``(xs, ys)`` numpy arrays of ``nb`` batches of ``bs`` rows."""
    if kind == 'cnn_ensemble':
        x, y = images(nb * bs, seed=seed)
    else:
        rng = np.random.default_rng(seed)
        x = rng.normal(size=(nb * bs, 5)).astype(np.float32)
        y = rng.normal(size=(nb * bs, 1)).astype(np.float32)
    return (x.reshape((nb, bs) + x.shape[1:]),
            y.reshape((nb, bs) + y.shape[1:]))


def per_batch(model, xs, ys, seeds):
    return torch.stack([
        model.validation_loss((xs[b], ys[b]), seed=seeds[b])
        for b in range(xs.shape[0])])


@pytest.fixture
def trainer(tmp_path):
    return ptr.Trainer('t', {}, callbacks=[], log_dir=str(tmp_path),
                       device='cpu')


def seeds_of(trainer, nb, epoch=3):
    """The trainer's validation seeds of batches ``0 .. nb - 1``."""
    return [trainer._val_seed(epoch, b) for b in range(nb)]


@pytest.mark.parametrize('shape', sorted(SHAPES))
@pytest.mark.parametrize('kind', KINDS)
def test_batched_losses_equal_the_per_batch_losses(kind, shape, trainer):
    nb, bs = SHAPES[shape]
    pm = port_of(jax_model(kind))
    xs, ys = (torch.from_numpy(a) for a in batches(kind, nb, bs))
    seeds = seeds_of(trainer, nb)
    got = pm.validation_losses(xs, ys, seeds)
    want = per_batch(pm, xs, ys, seeds)
    assert got.shape == (nb,) and got.dtype == torch.float32
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=REL, atol=0)
    if kind == 'mc_dropout':
        # each batch draws with its own seed: the batches' losses differ
        # from a pass drawn with one seed for every batch
        one = pm.validation_losses(xs, ys, [seeds[0]] * nb)
        assert not torch.equal(one[1:], got[1:])


@pytest.mark.parametrize('kind', KINDS)
def test_batched_losses_match_jax(kind, trainer):
    nb, bs = 3, 64
    stochastic = kind == 'mc_dropout'
    jm = jax_model(kind, num_samples=STAT_SAMPLES if stochastic else 8)
    pm = port_of(jm)
    xs, ys = batches(kind, nb, bs, seed=7)
    got = pm.validation_losses(torch.from_numpy(xs), torch.from_numpy(ys),
                               seeds_of(trainer, nb)).numpy()

    def jax_losses(key):
        return np.array([float(jm.validation_loss(
            jm.params, jm.state, (jnp.asarray(xs[b]), jnp.asarray(ys[b])),
            jax.random.PRNGKey(key + b))) for b in range(nb)])
    want = jax_losses(0)
    if not stochastic:
        np.testing.assert_allclose(got, want, rtol=TOL_JAX, atol=TOL_JAX)
        return
    noise = float(np.abs(want - jax_losses(100)).max())
    dev = float(np.abs(got - want).max())
    assert noise > 0
    assert dev <= STAT_FACTOR * noise, (dev, noise)


@pytest.mark.parametrize('kind', KINDS)
def test_trainer_pass_with_a_tail_equals_the_per_batch_pass(kind, trainer):
    """``Trainer._val_losses`` over 3 full batches and a tail of 37 rows
    (4 batches) against the per-batch losses with the trainer's seeds."""
    bs, tail = 100, 37
    pm = port_of(jax_model(kind))
    xs, ys = batches(kind, 4, bs, seed=9)
    x = torch.from_numpy(xs.reshape((-1,) + xs.shape[2:])[:3 * bs + tail])
    y = torch.from_numpy(ys.reshape((-1,) + ys.shape[2:])[:3 * bs + tail])
    got = trainer._val_losses(pm, x, y, bs, 4, epoch=5)
    want = torch.stack([
        pm.validation_loss((x[lo:lo + bs], y[lo:lo + bs]),
                           seed=trainer._val_seed(5, b))
        for b, lo in enumerate(range(0, x.shape[0], bs))])
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=REL, atol=0)
    # limit_val_batches below the full batches: no tail
    np.testing.assert_allclose(
        trainer._val_losses(pm, x, y, bs, 2, epoch=5).numpy(),
        want[:2].numpy(), rtol=REL, atol=0)


WRAPPERS = {'ensemble': (ensemble, 'fused_forward_prefolded'),
            'mc_dropout': (mc_dropout, 'fused_mc_forward'),
            'delta_uq': (delta_uq, 'fused_anchored_stats'),
            'pager': (delta_uq, 'fused_anchored_stats')}


@pytest.mark.parametrize('tail', [0, 37])
@pytest.mark.parametrize('kind', sorted(WRAPPERS))
def test_a_pass_calls_the_kernel_wrapper_once(kind, tail, monkeypatch,
                                             trainer):
    """One call of the model's kernel wrapper for the full batches, one
    more for a tail: on the card, one launch each."""
    module, name = WRAPPERS[kind]
    calls = []
    wrapped = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(args[1].shape[0])
        return wrapped(*args, **kwargs)
    monkeypatch.setattr(module, name, counted)
    pm = port_of(jax_model(kind))
    bs, nb = 128, 5
    xs, ys = batches(kind, nb + 1, bs, seed=2)
    n = nb * bs + tail
    x = torch.from_numpy(xs.reshape(-1, 5)[:n])
    y = torch.from_numpy(ys.reshape(-1, 1)[:n])
    losses = trainer._val_losses(pm, x, y, bs, nb + (tail > 0), epoch=0)
    assert losses.shape == (nb + (tail > 0),)
    assert calls == [nb * bs] + ([tail] if tail else [])


def test_a_model_without_validation_losses_is_scored_batch_by_batch(
        trainer):
    """A model object that keeps to the JAX package's interface (only
    ``validation_loss``) still validates, one call a batch."""
    seen = []

    class PerBatchOnly:
        net = torch.nn.Module()

        def validation_loss(self, batch, seed):
            seen.append((batch[0].shape[0], seed))
            return batch[1].mean()
    x = torch.arange(10.0)[:, None]
    got = trainer._val_losses(PerBatchOnly(), x, x, 4, 3, epoch=1)
    torch.testing.assert_close(got, torch.tensor([1.5, 5.5, 8.5]))
    assert seen == [(4, trainer._val_seed(1, 0)), (4, trainer._val_seed(1, 1)),
                    (2, trainer._val_seed(1, 2))]


@pytest.mark.parametrize('bs', [64, 100, 7, 1])
@pytest.mark.parametrize('row0', [0, 5, 300])
def test_seed_table_masks_are_the_per_batch_masks(bs, row0):
    """Row ``R`` of a table call draws ``seeds[R // bs]``'s mask at row
    ``R % bs``: the rows ``row0 ..`` of a table call equal, bit for bit,
    the same rows of the per-batch calls (each with its seed, its first
    row row 0)."""
    nb = -(-(row0 + 200) // bs)
    seeds = [(2**32 - 1 - 977 * b) if b % 2 else 12345 * b + 1
             for b in range(nb)]
    threshold, scale = mc.keep_threshold(0.3)
    for sample, key in ((0, 1), (6, 4)):
        per = torch.cat([mc.dropout_scale(s, sample, key, threshold, scale,
                                          bs, 33, 'cpu') for s in seeds])
        got = mc.dropout_scale(0, sample, key, threshold, scale, 200, 33,
                               'cpu', row0, seeds, bs)
        assert torch.equal(got, per[row0:row0 + 200])
        assert 0 < float((got == 0).float().mean()) < 1


def test_seed_table_call_equals_the_per_batch_calls(trainer):
    """The plain version of kernel 2 and the module walk with a table
    against one call a batch: masks bit for bit, statistics within 1e-6
    (products over other row counts)."""
    pm = port_of(jax_model('mc_dropout'))
    mw = pm.mc_weights()
    xs, _ = batches('mc_dropout', 3, 100)
    x = torch.from_numpy(xs.reshape(-1, 5))
    seeds = seeds_of(trainer, 3)
    for fn, first in ((mc.fused_mc_forward, mw),
                      (mc.mc_forward_modules, pm.net)):
        with torch.no_grad():
            got = fn(first, x, 8, 0, 0, seeds, 100)
            want_all = [fn(first, x[100 * b:100 * (b + 1)], 8, seeds[b])
                        for b in range(3)]
        for b, want in enumerate(want_all):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g[100 * b:100 * (b + 1)].numpy(),
                                           w.numpy(), rtol=REL, atol=1e-7)


@pytest.mark.parametrize('seeds,rps,message', [
    ([1, 2], 100, 'do not cover'),
    ([1, 2, 3], 0, 'at least 1'),
    ([1, 2**32, 3], 100, 'uint32'),
])
def test_a_short_or_bad_seed_table_raises(seeds, rps, message):
    pm = port_of(jax_model('mc_dropout'))
    x = torch.zeros(300, 5)
    with pytest.raises(ValueError, match=message):
        mc.fused_mc_forward(pm.mc_weights(), x, 4, 0, 0, seeds, rps)
