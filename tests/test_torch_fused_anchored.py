"""The port's Δ-UQ and PAGER serving path on the CPU against the JAX
package: the anchored kernel's plain version against the JAX
``fused_anchored_stats`` run in Pallas interpret mode (as
tests/test_fused_anchored.py runs it), the kernel's gate against the JAX
gate, the models against the JAX models' default CPU path, the builders,
bundles both ways, ``Predictor`` and the errors.

Tolerances: mean 1e-5 absolute and relative; std 1e-3 relative, 1e-5
absolute (the shifted one-pass variance against the JAX paths' two-pass and
Chan combines; as tests/torch_parity.py). The kernel itself is held to the
plain version on a card by tests/test_torch_cuda.py."""
import functools

import numpy as np
import pytest
import torch

from nnueehcs_tpu.model_builder import \
    DeltaUQMLPModelBuilder as JaxDeltaUQMLPModelBuilder
from nnueehcs_tpu.model_builder import PAGERModelBuilder as JaxPAGERModelBuilder
from nnueehcs_tpu.ops import fused_anchored as jax_fa
from nnueehcs_tpu.training import load_model as jax_load_model
from nnueehcs_tpu.training import save_model as jax_save_model
from nnueehcs_tpu_torch.model_builder import (DeltaUQMLPModelBuilder,
                                              PAGERModelBuilder)
from nnueehcs_tpu_torch.models import DeltaUQMLP
from nnueehcs_tpu_torch.models.delta_uq import anchored_input
from nnueehcs_tpu_torch.ops import fused_anchored as fa
from nnueehcs_tpu_torch.serving import Predictor
from nnueehcs_tpu_torch.training import load_model, save_model

from torch_parity import (TOL_MEAN, TOL_STD, assert_ue_close, descr,
                          jax_anchored, port_of)


@pytest.fixture
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))


def _x(rows, in_dim=5, seed=0):
    return np.random.default_rng(seed).normal(size=(rows, in_dim)).astype(
        np.float32)


def _anchored_layers(in_dim=5, width=32, hidden=2, out_dim=1, bn=True):
    return descr(in_dim=in_dim, width=width, hidden=hidden, out_dim=out_dim,
                 bn=bn)


@pytest.mark.parametrize('estimator,n_anchors,stored', [
    ('std', 7, 7), ('var', 7, 7), ('std', 4, 9), ('var', 3, 9)])
def test_plain_matches_jax_fused_anchored_stats(interpret_pallas, estimator,
                                                n_anchors, stored):
    """The kernel's plain version against the TPU kernel itself (interpret
    mode), with fewer anchors used than stored where n_anchors < stored."""
    jm = jax_anchored(_anchored_layers(), num_anchors=n_anchors,
                      stored=stored, estimator=estimator)
    pm = port_of(jm)
    x = _x(300, seed=5)
    cache = jax_fa.prepare_fused_anchored(jm.net, jm.params, jm.state)
    assert cache.folded
    ref = jax_fa.fused_anchored_stats(cache, x, jm.anchors, n_anchors)
    aw = fa.prepare_fused_anchored(pm.net)
    got = fa.fused_anchored_stats(aw, torch.from_numpy(x), pm.anchors,
                                  n_anchors)
    assert_ue_close(got, ref)
    # and the model's UE (std or std^2) against the JAX model's CPU path
    want = jm(x, return_ue=True)
    mean, spread = pm(x, return_ue=True)
    if estimator == 'var':
        np.testing.assert_allclose(spread.numpy(), np.asarray(got[1]) ** 2,
                                   **TOL_STD)
    assert_ue_close((mean, spread), want)


@pytest.mark.parametrize('layers,fuses', [
    (_anchored_layers(), True),                                  # flagship-like
    (_anchored_layers(in_dim=100, width=128), True),             # wide input
    (_anchored_layers(hidden=1), True),                          # two Linears
    (_anchored_layers(hidden=4, bn=False), True),                # no BatchNorm
    (_anchored_layers(out_dim=3), True),                         # 3 outputs
    (_anchored_layers(hidden=0), False),                         # one Linear
    (_anchored_layers(width=256), False),                        # width > 128
    (_anchored_layers(out_dim=200), False),                      # output > 128
    ([{'Linear': {'args': [5, 16]}}, {'ReLU': {}}, {'Dropout': {'args': [0.2]}},
      {'Linear': {'args': [16, 1]}}], False),                    # dropout
])
def test_gate_matches_jax(layers, fuses):
    """The port folds a network for its kernel exactly when the JAX package
    folds it for ``_anchored_kernel``."""
    jm = jax_anchored(layers, num_anchors=3)
    jax_fused = bool(jax_fa.prepare_fused_anchored(jm.net, jm.params,
                                                   jm.state).folded)
    assert jax_fused == fuses
    assert (fa.prepare_fused_anchored(port_of(jm).net) is not None) == fuses


def test_gate_rejects_odd_first_input():
    from nnueehcs_tpu_torch.model_builder import MLPModelBuilder
    m = MLPModelBuilder(descr(in_dim=5, width=16, hidden=1), device='cpu').build()
    assert fa.prepare_fused_anchored(m.net) is None


def test_split_and_packing():
    jm = jax_anchored(_anchored_layers(in_dim=7, width=32, hidden=3, out_dim=2))
    aw = fa.prepare_fused_anchored(port_of(jm).net)
    cache = jax_fa.prepare_fused_anchored(jm.net, jm.params, jm.state)
    assert (aw.in_dim, aw.out_dim, aw.num_layers, aw.width0) == (7, 2, 4, 32)
    assert aw.relus == (True, True, True, False) and cache.relu0
    np.testing.assert_allclose(aw.w0d.numpy(), np.asarray(cache.w0d),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(aw.ws[0][0].numpy(),
                               np.asarray(cache.w0x)[:7], rtol=1e-6, atol=1e-7)
    assert aw.macs_once == 7 * 32
    assert aw.macs_per_anchor == 2 * 32 * 32 + 32 * 2
    v = fa.anchor_rows(aw, torch.ones(5, 7))
    assert tuple(v.shape) == (5, 128) and float(v[:, 32:].abs().sum()) == 0


@pytest.mark.parametrize('kind,estimator', [('delta_uq', 'std'),
                                            ('delta_uq', 'var'),
                                            ('pager', 'std'), ('pager', 'var')])
def test_models_match_jax(kind, estimator):
    jm = jax_anchored(_anchored_layers(hidden=3), kind=kind, num_anchors=6,
                      estimator=estimator, seed=1)
    pm = port_of(jm)
    assert type(pm).__name__ == type(jm).__name__
    x = _x(300, seed=2)
    assert_ue_close(pm(x, return_ue=True), jm(x, return_ue=True))
    np.testing.assert_allclose(pm(x).numpy(), np.asarray(jm(x)), **TOL_MEAN)


@pytest.mark.parametrize('kind', ['delta_uq', 'pager'])
def test_module_path_matches_jax(kind):
    """Networks the kernel does not take, and a single anchor, run the
    anchored passes through the modules, as the JAX package's vmap path."""
    jm = jax_anchored(_anchored_layers(width=160), kind=kind, num_anchors=5)
    pm = port_of(jm)
    assert pm.anchored_weights() is None
    x = _x(100, seed=3)
    assert_ue_close(pm(x, return_ue=True), jm(x, return_ue=True))
    one = jax_anchored(_anchored_layers(), kind=kind, num_anchors=1)
    pone = port_of(one)
    mean, spread = pone(x, return_ue=True)
    ref_mean, ref_spread = (np.asarray(t) for t in one(x, return_ue=True))
    np.testing.assert_allclose(mean.numpy(), ref_mean, **TOL_MEAN)
    np.testing.assert_array_equal(np.isnan(spread.numpy()),
                                  np.isnan(ref_spread))


def test_module_path_groups_combine_like_one_group():
    """Anchor groups bounded by the rows budget (Chan's update) give what
    one group does, and match the fused plain version."""
    pm = port_of(jax_anchored(_anchored_layers(), num_anchors=9))
    x = torch.from_numpy(_x(64, seed=4))
    with torch.no_grad():
        whole = pm.anchored_stats_modules(x, pm.anchors, 9)
        pm.anchor_rows_budget = 128                    # 2 anchors per group
        grouped = pm.anchored_stats_modules(x, pm.anchors, 9)
    assert_ue_close(grouped, whole)
    assert_ue_close(fa.fused_anchored_stats(pm.anchored_weights(), x,
                                            pm.anchors, 9), whole)


def test_rows_budget_follows_anchored_batch_size():
    jm = jax_anchored(_anchored_layers(), num_anchors=229,
                      anchored_batch_size=229)
    pm = port_of(jm)
    assert pm.batch_size == 229 and pm._rows_budget() == jm._rows_budget()
    pm.batch_size = 10_000
    assert pm._rows_budget() == 1 << 20


def test_builders_match_jax():
    layers = _anchored_layers()
    cfg = {'estimator': 'var', 'num_anchors': 4}
    for port_b, jax_b in ((DeltaUQMLPModelBuilder, JaxDeltaUQMLPModelBuilder),
                          (PAGERModelBuilder, JaxPAGERModelBuilder)):
        jb = jax_b(layers, cfg, train_config={'loss': 'l1_loss'})
        jm = jb.build()
        pb = port_b(layers, cfg, device='cpu')
        pm = pb.build()
        assert pm.net.architecture == jm.net.architecture
        assert pm.net.architecture[0] == {'Linear': {'args': [10, 32]}}
        assert pb.model_descr == jb.model_descr
        assert (pm.estimator, pm.num_anchors) == ('var', 4)
        pb.build()                                     # doubles only once
        assert pb.model_descr[0] == {'Linear': {'args': [10, 32]}}
    assert layers[0] == {'Linear': {'args': [5, 32]}}


def test_anchored_input_is_anchor_then_offset():
    x = torch.arange(6.).reshape(2, 3)
    a = torch.ones(2, 3)
    assert torch.equal(anchored_input(x, a), torch.cat([a, x - a], dim=1))


@pytest.mark.parametrize('kind', ['delta_uq', 'pager'])
def test_jax_bundle_loads_and_port_bundle_loads_in_jax(kind, tmp_path):
    jm = jax_anchored(_anchored_layers(hidden=3), kind=kind, num_anchors=5,
                      stored=8, estimator='var', anchored_batch_size=64,
                      val_num_anchors=3)
    path = str(tmp_path / 'jax.pth')
    jax_save_model(jm, path)
    pm = load_model(path, device='cpu')
    assert (pm.estimator, pm.num_anchors, pm.batch_size,
            pm.val_num_anchors) == ('var', 5, 64, 3)
    np.testing.assert_array_equal(pm.anchors.numpy(), np.asarray(jm.anchors))
    if kind == 'pager':
        np.testing.assert_array_equal(pm.anchors_Y.numpy(),
                                      np.asarray(jm.anchors_Y))
    x = _x(80, seed=6)
    assert_ue_close(pm(x, return_ue=True), jm(x, return_ue=True))
    out = str(tmp_path / 'port.pth')
    save_model(pm, out)
    back = jax_load_model(out)
    assert type(back).__name__ == type(jm).__name__
    assert back.config_dict() == jm.config_dict()
    assert_ue_close(back(x, return_ue=True), jm(x, return_ue=True))


def test_bundle_without_anchors_round_trips(tmp_path):
    jm = jax_anchored(_anchored_layers(), num_anchors=3)
    jm.anchors = None
    path = str(tmp_path / 'jax.pth')
    jax_save_model(jm, path)
    pm = load_model(path, device='cpu')
    assert pm.anchors is None
    save_model(pm, str(tmp_path / 'port.pth'))
    assert jax_load_model(str(tmp_path / 'port.pth')).anchors is None


@pytest.mark.parametrize('kind', ['delta_uq', 'pager'])
def test_model_without_anchors_raises(kind):
    jm = jax_anchored(_anchored_layers(), kind=kind, num_anchors=3)
    pm = port_of(jm)
    pm.anchors = None
    with pytest.raises(ValueError, match='no anchors'):
        pm(_x(10), return_ue=True)
    with pytest.raises(ValueError, match='no anchors'):
        pm(_x(10))


def test_pager_without_anchor_targets_raises():
    jm = jax_anchored(_anchored_layers(), kind='pager', num_anchors=3)
    pm = port_of(jm)
    pm.anchors_Y = None
    with pytest.raises(ValueError, match='anchors_Y'):
        pm(_x(10), return_ue=True)
    jm.anchors_Y = None
    with pytest.raises(ValueError, match='anchors_Y'):
        jm(_x(10), return_ue=True)


def test_pager_score_is_the_max_anchor_error():
    jm = jax_anchored(_anchored_layers(), kind='pager', num_anchors=4, seed=2)
    pm = port_of(jm)
    x = torch.from_numpy(_x(20, seed=7))
    with torch.no_grad():
        p = pm.prediction_matrix(x, pm.anchors[:4])
        want = torch.stack([torch.stack([
            pm.net(anchored_input(pm.anchors[a][None], x[s][None]))[0, 0]
            for a in range(4)]) for s in range(20)])
        assert torch.allclose(p, want, **TOL_MEAN)
        pm.anchor_rows_budget = 8                     # 2 samples per chunk
        assert torch.allclose(pm.prediction_matrix(x, pm.anchors[:4]), p,
                              **TOL_MEAN)
        _, spread = pm.anchored_stats_modules(x, pm.anchors, 4)
        _, ue = pm(x.numpy(), return_ue=True)
    score = (p - pm.anchors_Y[:4].reshape(1, -1)).abs().amax(1, keepdim=True)
    np.testing.assert_allclose(ue.numpy(), torch.maximum(spread, score).numpy(),
                               **TOL_STD)


@pytest.mark.parametrize('kind', ['delta_uq', 'pager'])
def test_predictor_matches_jax(kind):
    jm = jax_anchored(_anchored_layers(hidden=3), kind=kind, num_anchors=6)
    pred = Predictor(port_of(jm), buckets=(256, 1024), device='cpu')
    for rows in (1, 300, 1500):
        x = _x(rows, seed=rows)
        got = pred.predict(x)
        assert got[0].shape == got[1].shape == (rows, 1)
        assert_ue_close(got, jm(x, return_ue=True))


def test_cpu_tensor_runs_the_plain_version_without_a_launch():
    pm = port_of(jax_anchored(_anchored_layers(), num_anchors=5))
    aw = pm.anchored_weights()
    x = torch.from_numpy(_x(50))
    before = fa.fused_anchored_stats.launches
    got = fa.fused_anchored_stats(aw, x, pm.anchors)
    assert fa.fused_anchored_stats.launches == before
    want = fa.fused_anchored_plain(aw, x, fa.anchor_rows(aw, pm.anchors))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(TypeError, match='float32'):
        fa.fused_anchored_stats(aw, x.bfloat16(), pm.anchors)
    with pytest.raises(ValueError, match='shape'):
        fa.fused_anchored_stats(aw, torch.zeros(4, 6), pm.anchors)
    with pytest.raises(ValueError, match='anchors'):
        fa.fused_anchored_stats(aw, x, torch.zeros(3, 4))


def test_estimator_is_checked():
    with pytest.raises(ValueError, match='estimator'):
        DeltaUQMLPModelBuilder(_anchored_layers(), {'estimator': 'iqr'},
                               device='cpu').build()
    assert issubclass(DeltaUQMLP, object)
