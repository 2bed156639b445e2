"""The port's KDE and kNN-KDE scoring against the JAX package on the CPU:
``kde_logpdf_plain`` (the kernel's plain version) and ``kde_logpdf`` against
JAX ``kde_logpdf_xla`` and ``kde_logpdf``, the exact kNN distances and
density against JAX's exact path, and the bandwidth rules. On the CPU the
JAX package reaches its Pallas ``_kde_kernel`` only through this XLA
reference (its Pallas test skips off the TPU), so that is what the port is
held to here; the CUDA kernel is held to ``kde_logpdf_plain`` on a card by
tests/test_torch_cuda.py.

Tolerances: log density 1e-4 absolute plus 1e-5 relative, for float32
round-off in the decomposition ``|x|^2 + |y|^2 - 2 x.y`` (taken by another
matrix product in each package), which gamma scales up; never looser than
the JAX package's own 1e-3 Pallas-vs-XLA bar (tests/test_kernels.py).
Squared kNN distances 1e-5 relative plus 1e-5 absolute (the same round-off
without gamma); kNN densities 1e-4 relative plus a tiny absolute: the
density is exp of a log-sum-exp of -gamma * sqd, so it carries the log
density's 1e-4 absolute bar through exp (committed minibude kNN bundles
reach 1.15e-5 relative between the packages, tests/torch_bundle_sweep.py)."""
import numpy as np
import pytest
import torch

from nnueehcs_tpu.ops import kde as jkde
from nnueehcs_tpu_torch.ops import kde

TOL_LOGPDF = {'rtol': 1e-5, 'atol': 1e-4}
TOL_SQD = {'rtol': 1e-5, 'atol': 1e-5}
TOL_DENSITY = {'rtol': 1e-4, 'atol': 1e-30}


def _data(n, b, d, seed=0, offset=0.0):
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=(n, d)) + offset).astype(np.float32)
    x = (rng.normal(size=(b, d)) * 1.2 + offset).astype(np.float32)
    return data, x


def _centred(x, data):
    c = data.mean(0)
    return x - c, data - c


def _logpdf_f64(x, data, h):
    """The exact log density in float64 numpy, pairwise differences first."""
    x, data = x.astype(np.float64), data.astype(np.float64)
    e = -((x[:, None, :] - data[None]) ** 2).sum(-1) / (2 * h * h)
    m = e.max(1)
    n, d = data.shape
    return m + np.log(np.exp(e - m[:, None]).sum(1)) - np.log(n) \
        - d * np.log(h) - 0.5 * d * np.log(2 * np.pi)


CASES = {
    # name: (n, b, d, chunk, offset)
    'small': (300, 50, 5, 8192, 0.0),
    'chunked_32': (300, 50, 5, 32, 0.0),     # as tests/test_kernels.py
    'ragged_chunks': (1001, 77, 5, 128, 0.0),
    'd1': (257, 31, 1, 64, 0.0),
    'd8': (513, 65, 8, 100, 0.0),
    'd37': (301, 19, 37, 64, 0.0),
    'offset_1e3': (400, 60, 5, 128, 1e3),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_matches_jax_xla(case):
    n, b, d, chunk, offset = CASES[case]
    data, x = _data(n, b, d, offset=offset)
    xc, dc = _centred(x, data)
    h = kde.bandwidth_value('scott', n, d)
    got = kde.kde_logpdf_plain(torch.from_numpy(xc), torch.from_numpy(dc), h,
                               chunk=chunk)
    want = np.asarray(jkde.kde_logpdf_xla(xc, dc, h, chunk=chunk))
    assert got.shape == (b,)
    np.testing.assert_allclose(got.numpy(), want, **TOL_LOGPDF)


@pytest.mark.parametrize('case', sorted(CASES))
def test_kde_logpdf_matches_jax(case):
    """The entry point centres at the reference mean, as JAX's does; on a
    CPU tensor it runs the plain version and counts no launch."""
    n, b, d, _, offset = CASES[case]
    data, x = _data(n, b, d, seed=1, offset=offset)
    h = kde.bandwidth_value('silverman', n, d)
    before = kde.kde_logpdf.launches
    got = kde.kde_logpdf(torch.from_numpy(x), torch.from_numpy(data), h)
    assert kde.kde_logpdf.launches == before
    want = np.asarray(jkde.kde_logpdf(x, data, h))
    np.testing.assert_allclose(got.numpy(), want, **TOL_LOGPDF)


def test_offset_needs_the_centring():
    """At a +1e3 offset the uncentred float32 decomposition loses the
    density; the centred one keeps it (the reason both packages centre)."""
    data, x = _data(400, 60, 5, seed=2, offset=1e3)
    h = 0.3
    exact = _logpdf_f64(x, data, h)
    got = kde.kde_logpdf(torch.from_numpy(x), torch.from_numpy(data), h)
    np.testing.assert_allclose(got.numpy(), exact, **TOL_LOGPDF)
    raw = kde.kde_logpdf_plain(torch.from_numpy(x), torch.from_numpy(data), h)
    assert float(np.abs(raw.numpy() - exact).max()) > 1.0


def test_far_ood_rows_are_finite_and_score_zero():
    """Queries 50 bandwidths away: every exp underflows, yet the running max
    keeps the log density finite, and the score -exp(.) is 0 in float32 in
    both packages."""
    data, _ = _data(500, 1, 5, seed=3)
    h = kde.bandwidth_value('silverman', 500, 5)
    rng = np.random.default_rng(4)
    far = np.abs(data).max() * 2 + 50 * h
    x = (rng.normal(size=(40, 5)) + far).astype(np.float32)
    got = kde.kde_logpdf(torch.from_numpy(x), torch.from_numpy(data), h)
    want = np.asarray(jkde.kde_logpdf(x, data, h))
    assert np.isfinite(got.numpy()).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL_LOGPDF)
    assert float(-torch.exp(got).abs().max()) == 0.0
    assert float(np.abs(-np.exp(want)).max()) == 0.0


def test_plain_tiles_queries(monkeypatch):
    """Query tiling (which keeps the (rows, chunk) buffer near 1 GiB) changes
    no answer."""
    data, x = _data(700, 90, 5, seed=5)
    xc, dc = (torch.from_numpy(a) for a in _centred(x, data))
    whole = kde.kde_logpdf_plain(xc, dc, 0.4, chunk=256)
    monkeypatch.setattr(kde, '_BUFFER_ELEMENTS', 256 * 7)
    tiled = kde.kde_logpdf_plain(xc, dc, 0.4, chunk=256)
    np.testing.assert_array_equal(tiled.numpy(), whole.numpy())


def test_kde_refuses_bad_inputs():
    data = torch.zeros(10, 5)
    with pytest.raises(TypeError):
        kde.kde_logpdf(torch.zeros(3, 5, dtype=torch.float64), data, 0.5)
    with pytest.raises(ValueError):
        kde.kde_logpdf(torch.zeros(3, 4), data, 0.5)
    with pytest.raises(ValueError):
        kde.kde_logpdf(torch.zeros(3, 5), torch.zeros(0, 5), 0.5)


@pytest.mark.parametrize('rule,n,d', [('scott', 1000, 5), ('silverman', 1000, 5),
                                      ('scott', 45824, 6),
                                      ('silverman', 16384, 5), (0.25, 10, 3)])
def test_bandwidth_rules_match_jax(rule, n, d):
    assert kde.bandwidth_value(rule, n, d) == jkde.bandwidth_value(rule, n, d)


def test_unknown_bandwidth_rule_raises():
    with pytest.raises(ValueError, match='bandwidth'):
        kde.bandwidth_value('tophat', 10, 2)


KNN_CASES = {
    # name: (n, b, d, k, chunk)
    'k1': (300, 40, 5, 1, 4096),
    'k_n': (300, 40, 5, 300, 4096),
    'k_above_n': (300, 40, 5, 400, 4096),
    'chunked': (1000, 40, 6, 17, 128),          # N above the chunk size
    'chunked_k_n': (500, 20, 3, 500, 64),
    'offset_1e3': (600, 30, 5, 9, 4096),
}


@pytest.mark.parametrize('case', sorted(KNN_CASES))
def test_knn_sq_dists_match_jax_exact(case):
    n, b, d, k, chunk = KNN_CASES[case]
    data, x = _data(n, b, d, seed=6, offset=1e3 if 'offset' in case else 0.0)
    got = kde.knn_sq_dists(torch.from_numpy(x), torch.from_numpy(data), k,
                           chunk=chunk)
    want = np.asarray(jkde.knn_sq_dists(x, data, k, chunk=chunk, exact=True))
    assert got.shape == (b, min(k, n))
    np.testing.assert_allclose(got.numpy(), want, **TOL_SQD)


def test_knn_tiles_queries(monkeypatch):
    data, x = _data(900, 70, 5, seed=7)
    args = (torch.from_numpy(x), torch.from_numpy(data), 11)
    whole = kde.knn_sq_dists(*args, chunk=200)
    monkeypatch.setattr(kde, '_BUFFER_ELEMENTS', 211 * 9)
    np.testing.assert_array_equal(kde.knn_sq_dists(*args, chunk=200).numpy(),
                                  whole.numpy())


@pytest.mark.parametrize('k', [1, 5, 300, 1000])
def test_knn_kde_density_matches_jax(k):
    """The normalising constant is over the whole corpus, not over k, so at
    k >= N the truncated density is the exact KDE."""
    data, x = _data(300, 40, 5, seed=8)
    h = kde.bandwidth_value('scott', 300, 5)
    got = kde.knn_kde_density(torch.from_numpy(x), torch.from_numpy(data), h, k)
    want = np.asarray(jkde.knn_kde_density(x, data, h, k, exact=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL_DENSITY)
    if k >= 300:
        full = np.exp(np.asarray(jkde.kde_logpdf(x, data, h)))
        np.testing.assert_allclose(got.numpy(), full, rtol=1e-4)


@pytest.mark.parametrize('exact,b,n', [('auto', 10, 10), ('auto', 1 << 14, 1 << 13),
                                       (None, 1, 1), (True, 1 << 20, 1 << 20),
                                       (False, 1, 1)])
def test_resolve_knn_exact_matches_jax(exact, b, n):
    assert kde.KNN_EXACT_AUTO_PAIRS == jkde.KNN_EXACT_AUTO_PAIRS
    assert kde.resolve_knn_exact(exact, b, n) == \
        jkde.resolve_knn_exact(exact, b, n)
