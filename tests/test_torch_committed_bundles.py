"""Committed trained bundles (``experiments/full_cell/artifacts/*/
pareto_models/``) through both packages on the CPU: one bundle of each UQ
class, loaded by the JAX package and by the port, answers the same rows.

The minibude bundles are used throughout (6 inputs; the KDE and kNN-KDE
corpora are the 45,824 x 6 training inputs). Rows are half jittered corpus
rows and half standard normal, so the density scores are not all 0. The
kNN bundle names ``knn_exact: False``; the JAX package's CPU path is exact
all the same, as the port always is.

Tolerances: the mean/prediction 1e-5 absolute and relative; ensemble, Δ-UQ
and PAGER spread 1e-3 relative and 1e-5 absolute (tests/torch_parity.py);
the KDE and kNN scores 1e-4 relative (the log density's 1e-4 absolute,
tests/test_torch_kde.py); MVE sigma 1e-5 relative plus a tiny absolute.
The kNN bundle is the one whose score differs most between the packages
(1.15e-5 relative, tests/torch_bundle_sweep.py). MC dropout draws its masks from another generator in each
package, so its mean and std are held statistically: within 3 x the JAX
package's own deviation between two of its seeds
(tests/test_torch_mc_dropout.py)."""
import glob
import os
import pickle

import numpy as np
import pytest

from nnueehcs_tpu.training import load_model as jax_load_model
from nnueehcs_tpu_torch.models import model_class
from nnueehcs_tpu_torch.training import load_model

from torch_parity import TOL_MEAN, TOL_STD

EXPERIMENTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'experiments')
ARTIFACTS = os.path.join(EXPERIMENTS, 'full_cell', 'artifacts')
BUNDLES = {
    # class: (artifact directory, trial)
    'EnsembleModel': ('minibude_ensemble_gaps', 'bo_trial_13'),
    'MCDropoutModel': ('minibude_mc_dropout_gaps', 'bo_trial_0'),
    'DeltaUQMLP': ('minibude_delta_uq_gaps', 'bo_trial_4'),
    'PAGERMLP': ('minibude_pager_gaps', 'bo_trial_14'),
    'KDEMLPModel': ('minibude_kde_gaps', 'bo_trial_27'),
    'KNNKDEMLPModel': ('minibude_knn_kde_tails', 'bo_trial_25'),
    'MVEMLPModel': ('minibude_mve_gaps', 'bo_trial_10'),
}
ROWS = 300
TOL_UE = {'EnsembleModel': TOL_STD, 'DeltaUQMLP': TOL_STD,
          'PAGERMLP': TOL_STD, 'KDEMLPModel': {'rtol': 1e-4, 'atol': 1e-30},
          'KNNKDEMLPModel': {'rtol': 1e-4, 'atol': 1e-30},
          'MVEMLPModel': {'rtol': 1e-5, 'atol': 1e-12}}
STAT_FACTOR = 3.0


def rows_for(port_model, rows=ROWS, seed=0):
    """``rows`` inputs for a bundle: half jittered corpus rows (for a
    density model), the rest standard normal."""
    in_dim = port_model.net.layers[0].in_features
    if port_model.uq_method in ('delta_uq', 'pager'):
        in_dim //= 2
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, in_dim))
    corpus = getattr(port_model, 'kde', None)
    corpus = corpus.data if corpus is not None else \
        getattr(port_model, '_fit_data', None)
    if corpus is not None:
        picks = rng.integers(0, corpus.shape[0], rows // 2)
        x[:rows // 2] = corpus.numpy()[picks] + 0.05 * x[:rows // 2]
    return x.astype(np.float32)


def logpdf_f64(x, data, h, rows=8):
    """The exact Gaussian-KDE log density in float64 numpy (pairwise
    differences, no decomposition), ``rows`` queries at a time."""
    data = np.asarray(data, np.float64)
    n, d = data.shape
    out = []
    for i in range(0, len(x), rows):
        diff = np.asarray(x[i:i + rows], np.float64)[:, None] - data[None]
        e = -(diff ** 2).sum(-1) / (2 * h * h)
        m = e.max(1)
        out.append(m + np.log(np.exp(e - m[:, None]).sum(1)))
    return np.concatenate(out) - np.log(n) - d * np.log(h) \
        - 0.5 * d * np.log(2 * np.pi)


@pytest.mark.parametrize('cls', sorted(BUNDLES))
def test_committed_bundle_matches_jax(cls):
    folder, trial = BUNDLES[cls]
    path = os.path.join(ARTIFACTS, folder, 'pareto_models', trial, 'model.pth')
    jm = jax_load_model(path)
    pm = load_model(path, device='cpu')
    assert type(pm).__name__ == type(jm).__name__ == cls
    x = rows_for(pm)
    got = [t.numpy() for t in pm(x, return_ue=True)]
    if cls == 'MCDropoutModel':
        jm.reseed(1)
        a = [np.asarray(t) for t in jm(x, return_ue=True)]
        jm.reseed(2)
        b = [np.asarray(t) for t in jm(x, return_ue=True)]
        for i, name in enumerate(('mean', 'std')):
            noise = float(np.abs(a[i] - b[i]).max())
            assert 0 < float(np.abs(got[i] - a[i]).max()) <= STAT_FACTOR * noise
        return
    want = [np.asarray(t) for t in jm(x, return_ue=True)]
    np.testing.assert_allclose(got[0], want[0], **TOL_MEAN)
    assert got[1].shape == want[1].shape
    np.testing.assert_allclose(got[1], want[1], **TOL_UE[cls])
    assert np.abs(got[1]).max() > 0


def test_every_committed_bundle_names_a_ported_class():
    paths = glob.glob(os.path.join(EXPERIMENTS, '**', 'model.pth'),
                      recursive=True)
    classes = set()
    for path in paths:
        if os.path.isfile(path):
            with open(path, 'rb') as f:
                classes.add(pickle.load(f)['config']['class'])
    assert len(paths) >= 200 and set(BUNDLES) <= classes
    for name in classes:
        model_class(name)


def test_wide_corpus_kde_bundle_is_as_exact_as_jax():
    """The binomial_options KDE bundle of the kde_scale grid holds a
    128,000 x 5 corpus that spans |x| up to 100, where float32 round-off in
    |x|^2 + |y|^2 - 2 x.y reaches 1e-2 in log density in both packages, far
    above the 1e-4 bar. There the port is held to be as exact as the JAX
    package: its log density is no farther from a float64 evaluation than
    twice the JAX package's distance (the same float32 algorithm, rounded
    in another order), and the predictions agree to TOL_MEAN."""
    path = os.path.join(EXPERIMENTS, 'grid_r5', 'kde_scale_results',
                        'binomial_options', 'tails', 'kde', 'bo_trial_0',
                        'model.pth')
    jm, pm = jax_load_model(path), load_model(path, device='cpu')
    assert pm.kde.data.shape == (128_000, 5)
    x = rows_for(pm, 64)
    np.testing.assert_allclose(pm(x).numpy(), np.asarray(jm(x)), **TOL_MEAN)
    ref = logpdf_f64(x, pm.kde.data.numpy(), pm.kde.bandwidth_)
    port = np.abs(pm.kde.score_samples(x).numpy() - ref).max()
    jax_err = np.abs(np.asarray(jm.kde.score_samples(x)) - ref).max()
    assert jax_err > 1e-3
    assert port <= 2 * jax_err
