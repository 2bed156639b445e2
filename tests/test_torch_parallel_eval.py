"""Sharded UE evaluation in the port against the JAX package's sharded
evaluation (tests/conftest.py's 8 virtual CPU devices, meshes of the same
axis sizes) and against the port's own unsharded call.

One gloo world of 4 CPU ranks (``parallel.launch``, module-scoped) runs
every case of this file in its ranks (tests/torch_parallel_cases.py); the
test functions read its answers. Every rank must hold the whole answer,
so each case also checks that the ranks agree exactly.

Tolerances: the model answers as tests/torch_parity.py holds the port to
JAX (mean 1e-5, std 1e-3 relative over 1e-5), the KDE and kNN scores as
tests/test_torch_density_models.py holds them (1e-4 relative), the KDE
log density 1e-4 plus 1e-5 relative (tests/test_sharding.py holds JAX's
sharded KDE to its unsharded one within 1e-4), kNN distances rtol 1e-5.
Against the port's unsharded call the dp split changes no arithmetic of
a row, so dp answers must be equal; the member merge and the corpus merge
reorder sums (1e-6). The corpora are those of tests/test_sharding.py: 3,001
rows for KDE and 997 for kNN, neither a multiple of the 4 ranks, and a
corpus of 3 rows, smaller than the mesh. MC dropout's masks hash each row's index in the whole
bucket, so its dp-sharded answer is the unsharded one bit for bit, call
after call (the ranks' per-call seeds stay in step); its masks are not
JAX's draws, so it is not compared with JAX.
"""
import numpy as np
import pytest
import torch

from nnueehcs_tpu.ops import kde as jkde
from nnueehcs_tpu.parallel import make_mesh as jax_mesh
from nnueehcs_tpu_torch.ops import kde as pkde
from nnueehcs_tpu_torch.parallel import launch

import torch_parallel_cases as cases
from test_torch_cnn_models import images, jax_cnn
from test_torch_density_models import jax_density
from torch_parity import one_torch_thread  # noqa: F401
from torch_parity import (TOL_MEAN, TOL_STD, descr, jax_anchored,
                          jax_ensemble, jax_mc_dropout, port_of)

pytestmark = pytest.mark.usefixtures('one_torch_thread')

WORLD = 4
X = np.random.default_rng(7).normal(size=(300, 5)).astype(np.float32)
TOL_KDE = {'rtol': 1e-5, 'atol': 1e-4}
TOL_KDE_SCORE = {'rtol': 1e-4, 'atol': 1e-30}
TOL_MERGE = {'rtol': 1e-6, 'atol': 1e-6}


def _bundle(m):
    from nnueehcs_tpu_torch.training.checkpoint import FORMAT
    return {'format': FORMAT, 'config': m.config_dict(),
            'arrays': m.arrays_dict()}


def _jax_models():
    """name -> (JAX model, mesh axes, request)."""
    return {
        'ensemble_dp4': (jax_ensemble(descr(), members=4), {'dp': 4}, X),
        'ensemble_dp2_member2': (jax_ensemble(descr(), members=4),
                                 {'dp': 2, 'member': 2}, X),
        'ensemble_member4_one_each': (jax_ensemble(descr(), members=4),
                                      {'member': 4}, X),
        'delta_uq_dp4': (jax_anchored(descr()), {'dp': 4}, X),
        'pager_dp4': (jax_anchored(descr(), kind='pager'),
                      {'dp': 4}, X),
        'mve_dp4': (jax_density('mve'), {'dp': 4}, X),
        'kde_dp4': (jax_density('kde', rtol=1000), {'dp': 4}, X),
        'knn_kde_dp4': (jax_density('knn_kde', k=7), {'dp': 4}, X),
        'cnn_ensemble_dp4': (jax_cnn('ensemble'), {'dp': 4}, images(40)[0]),
    }


KDE_DATA = {n: np.random.default_rng(n).normal(size=(n, 4)).astype(np.float32)
            + 5.0 for n in (3001, 3)}
KDE_Q = np.random.default_rng(1).normal(size=(256, 4)).astype(np.float32) + 5.0
KNN_Q = np.random.default_rng(3).normal(size=(64, 4)).astype(np.float32)
KNN_DATA = {n: np.random.default_rng(n + 1).normal(size=(n, 4)).astype(
    np.float32) for n in (997, 3)}
KDE_CASES = [(f'kde_n{n}', 'kde', (KDE_Q, KDE_DATA[n], 0.4)) for n in KDE_DATA]
KNN_CASES = [(f'knn_n997_k{k}', 'knn', (KNN_Q, KNN_DATA[997], k))
             for k in (50,)] + [
    ('knn_n3_k5', 'knn', (KNN_Q, KNN_DATA[3], 5)),
    ('knn_density_n997_k25', 'knn_density', (KNN_Q, KNN_DATA[997], 0.4, 25))]
MC_NAME = 'mc_dropout_dp4'


@pytest.fixture(scope='module')
def world():
    """The JAX models and the answers of every rank of one 4-rank world."""
    models = _jax_models()
    mc = jax_mc_dropout(descr(hidden=3), num_samples=8)
    run = [(name, 'model', (_bundle(m), axes, x, 1))
           for name, (m, axes, x) in models.items()]
    run.append((MC_NAME, 'model', (_bundle(mc), {'dp': WORLD}, X, 2)))
    answers = launch(cases.eval_cases, WORLD, threads=1, all_ranks=True,
                     timeout=cases.WORLD_TIMEOUT,
                     args=(run + KDE_CASES + KNN_CASES,))
    return models, mc, answers


def _assert_equal(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _assert_equal(u, v)
    else:
        np.testing.assert_array_equal(a, b)


def _same_on_every_rank(answers, name):
    for other in answers[1:]:
        _assert_equal(answers[0][name], other[name])
    return answers[0][name]


MODEL_NAMES = [
    'ensemble_dp4', 'ensemble_dp2_member2', 'ensemble_member4_one_each',
    'delta_uq_dp4', 'pager_dp4', 'mve_dp4', 'kde_dp4', 'knn_kde_dp4',
    'cnn_ensemble_dp4']


@pytest.mark.parametrize('name', MODEL_NAMES)
def test_sharded_model_matches_jax_sharded_and_port_unsharded(world, name):
    models, _, answers = world
    jm, axes, x = models[name]
    (pred, ue), = _same_on_every_rank(answers, name)
    jm.attach_mesh(jax_mesh(axes))
    want_pred, want_ue = (np.asarray(a) for a in jm(x, return_ue=True))
    ref_pred, ref_ue = (t.numpy() for t in port_of(jm)(x, return_ue=True))
    assert pred.shape == want_pred.shape and ue.shape == want_ue.shape
    np.testing.assert_allclose(pred, want_pred, **TOL_MEAN)
    if 'kde' in name:
        np.testing.assert_allclose(ue, want_ue, **TOL_KDE_SCORE)
    else:
        np.testing.assert_allclose(ue, want_ue, **TOL_STD)
    if 'member' in axes:
        np.testing.assert_allclose(pred, ref_pred, **TOL_MERGE)
        np.testing.assert_allclose(ue, ref_ue, **TOL_MERGE)
    elif 'kde' in name:
        np.testing.assert_array_equal(pred, ref_pred)
        np.testing.assert_allclose(ue, ref_ue, **TOL_MERGE)
    else:
        np.testing.assert_array_equal(pred, ref_pred)
        np.testing.assert_array_equal(ue, ref_ue)


def test_mc_dropout_dp_sharded_is_the_unsharded_call_bit_for_bit(world):
    """Two calls in a row: each rank's call counter advances alike, so
    both calls equal the unsharded model's first two calls exactly."""
    _, mc, answers = world
    got = _same_on_every_rank(answers, MC_NAME)
    port = port_of(mc)
    for (pred, ue) in got:
        ref_pred, ref_ue = (t.numpy() for t in port(X, return_ue=True))
        np.testing.assert_array_equal(pred, ref_pred)
        np.testing.assert_array_equal(ue, ref_ue)
    assert not np.array_equal(got[0][1], got[1][1])   # new masks per call


@pytest.mark.parametrize('n', sorted(KDE_DATA))
def test_kde_logpdf_sharded_matches_jax_and_unsharded(world, n):
    _, _, answers = world
    got = _same_on_every_rank(answers, f'kde_n{n}')
    mesh = jax_mesh({'dp': WORLD})
    want = np.asarray(jkde.kde_logpdf_sharded(KDE_Q, KDE_DATA[n], 0.4, mesh))
    np.testing.assert_allclose(got, want, **TOL_KDE)
    ref = pkde.kde_logpdf(torch.from_numpy(KDE_Q),
                          torch.from_numpy(KDE_DATA[n]), 0.4).numpy()
    np.testing.assert_allclose(got, ref, **TOL_KDE)


@pytest.mark.parametrize('name', [c[0] for c in KNN_CASES])
def test_knn_sharded_matches_jax_and_exact(world, name):
    _, _, answers = world
    got = _same_on_every_rank(answers, name)
    kind, spec = next((c[1], c[2]) for c in KNN_CASES if c[0] == name)
    mesh = jax_mesh({'dp': WORLD})
    q, data = torch.from_numpy(spec[0]), torch.from_numpy(spec[1])
    if kind == 'knn':
        k = spec[2]
        want = np.asarray(jkde.knn_sq_dists_sharded(spec[0], spec[1], k,
                                                    mesh))
        ref = pkde.knn_sq_dists(q, data, k).numpy()
        assert got.shape == (64, min(k, spec[1].shape[0]))
        np.testing.assert_allclose(got, np.sort(want, 1), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    else:
        h, k = spec[2], spec[3]
        want = np.asarray(jkde.knn_kde_density_sharded(spec[0], spec[1], h,
                                                       k, mesh))
        ref = pkde.knn_kde_density(q, data, h, k).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)
        np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_member_count_that_does_not_divide_raises():
    """As JAX's NamedSharding refuses 3 members over a member axis of 2."""
    from nnueehcs_tpu_torch.parallel.mesh import Mesh
    m = port_of(jax_ensemble(descr(), members=3))
    with pytest.raises(ValueError, match='divisible by 2'):
        m.attach_mesh(Mesh({'member': 2}, 0, 'cpu', {}, 'gloo'))
