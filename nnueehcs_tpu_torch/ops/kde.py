"""Gaussian KDE and kNN-KDE density scoring: the KDE kernel's wrapper, its
plain PyTorch version and the exact kNN top-k.

Counterpart of ``nnueehcs_tpu/ops/kde.py`` without the mesh-sharded
functions. The exact Gaussian-KDE log density of a query ``x`` under a
reference corpus is ``logsumexp_j(-gamma * |x - y_j|^2)`` plus the log
normalising constant, with ``gamma = 1 / (2 h^2)`` and sklearn's bandwidth
rules. Both sides are first centred at the reference mean (distances are
translation invariant), so the float32 decomposition
``|x|^2 + |y|^2 - 2 x.y`` stays accurate for data with large offsets.

:func:`kde_logpdf` is the entry point: on a CUDA tensor it launches the
hand-written kernel (``csrc/kde.cu``) at every problem size, on a CPU
tensor it runs :func:`kde_logpdf_plain`, which streams a running
log-sum-exp over reference chunks as the JAX package's XLA path does. It
never falls back from one to the other.

kNN-KDE has no kernel in either package: :func:`knn_sq_dists` is an exact
running top-k merge over reference chunks in tensor ops, on any device.
sklearn's ``rtol`` pruning tolerance has no analogue in an exact
evaluation; the models record it and nothing reads it.
"""
from __future__ import annotations

import math
from typing import Union

import torch

_LOG_2PI = math.log(2.0 * math.pi)
# most float32 elements of one (query rows, reference chunk) buffer in the
# plain and kNN paths: 2^28 elements, 1 GiB
_BUFFER_ELEMENTS = 1 << 28


def bandwidth_value(bandwidth: Union[str, float], n: int, d: int) -> float:
    """sklearn's ``KernelDensity`` bandwidth rules: ``scott`` is
    ``n^(-1/(d+4))``, ``silverman`` ``(n (d+2) / 4)^(-1/(d+4))``; a number
    is taken as it is."""
    if isinstance(bandwidth, str):
        if bandwidth == 'scott':
            return float(n) ** (-1.0 / (d + 4))
        if bandwidth == 'silverman':
            return (n * (d + 2) / 4.0) ** (-1.0 / (d + 4))
        raise ValueError(f'Unknown bandwidth rule {bandwidth!r}')
    return float(bandwidth)


def _log_norm_const(n: int, d: int, h: float) -> float:
    return -math.log(n) - d * math.log(h) - 0.5 * d * _LOG_2PI


def centre(x, data):
    """``x`` and ``data`` as float32, both shifted by the reference mean."""
    x = torch.as_tensor(x, dtype=torch.float32)
    data = torch.as_tensor(data, dtype=torch.float32, device=x.device)
    center = data.mean(0)
    return x - center, data - center


def _sq_dists(x, data):
    """(B, N) squared distances ``max(|x|^2 + |y|^2 - 2 x.y, 0)``, the cross
    term as one full-float32 matrix product."""
    x2 = (x * x).sum(-1, keepdim=True)
    d2 = (data * data).sum(-1)
    return torch.clamp(x2 + d2 - 2.0 * (x @ data.T), min=0.0)


def _by_row_tiles(fn, x, cols: int):
    """``fn`` over tiles of at most ``_BUFFER_ELEMENTS // cols`` rows of
    ``x``, concatenated: a (tile, cols) buffer stays near 1 GiB. Rows are
    independent, so the tiling changes no answer."""
    step = max(1, _BUFFER_ELEMENTS // max(cols, 1))
    return torch.cat([fn(x[i:i + step])
                      for i in range(0, max(x.shape[0], 1), step)])


def _logpdf_tile(x, data, gamma: float, chunk: int):
    """Running log-sum-exp of ``-gamma * sqd`` over reference chunks: the
    chunk max first, the running sum rescaled once per chunk."""
    m = torch.full((x.shape[0],), -math.inf, dtype=x.dtype, device=x.device)
    s = torch.zeros_like(m)
    for start in range(0, data.shape[0], chunk):
        expnt = -_sq_dists(x, data[start:start + chunk]) * gamma
        m_new = torch.maximum(m, expnt.amax(1))
        # exp(-inf - finite) == 0, so the m == -inf start is benign
        s = s * torch.exp(m - m_new) + torch.exp(expnt - m_new[:, None]).sum(1)
        m = m_new
    return m + torch.log(s)


def kde_logpdf_plain(x, data, h: float, chunk: int = 8192):
    """The kernel's function in plain tensor ops: exact Gaussian-KDE log
    density of ``x`` (B, d) under ``data`` (N, d), neither centred here.
    The counterpart of the JAX package's ``kde_logpdf_xla``: the same
    decomposition and clamp, one log-sum-exp when ``N <= chunk``, else a
    running one over chunks of ``chunk`` references (the ragged last chunk
    holds only real references, so nothing needs masking). Queries go in
    tiles that keep each (rows, chunk) buffer near 1 GiB."""
    x = torch.as_tensor(x, dtype=torch.float32)
    data = torch.as_tensor(data, dtype=torch.float32, device=x.device)
    n, d = data.shape
    gamma = 1.0 / (2.0 * h * h)
    width = min(n, chunk)
    out = _by_row_tiles(lambda xt: _logpdf_tile(xt, data, gamma, width), x,
                        width)
    return out + _log_norm_const(n, d, h)


def _check_kde_inputs(x, data):
    if x.dtype != torch.float32 or data.dtype != torch.float32:
        raise TypeError(f'the KDE kernel takes float32, got {x.dtype} and '
                        f'{data.dtype}')
    if x.dim() != 2 or data.dim() != 2 or x.shape[1] != data.shape[1]:
        raise ValueError(f'expected x (B, d) and data (N, d), got '
                         f'{tuple(x.shape)} and {tuple(data.shape)}')
    if data.shape[0] == 0 or data.shape[1] == 0:
        raise ValueError('the reference corpus is empty')


def kde_logpdf(x, data, h: float):
    """Exact Gaussian-KDE log density (B,) of ``x`` (B, d) under ``data``
    (N, d), both centred at the reference mean first. A CUDA tensor runs
    the kernel at every size, a CPU tensor :func:`kde_logpdf_plain`.
    ``kde_logpdf.launches`` counts kernel launches."""
    x = torch.as_tensor(x)
    data = torch.as_tensor(data, device=x.device)
    _check_kde_inputs(x, data)
    xc, dc = centre(x, data)
    if x.device.type == 'cpu':
        return kde_logpdf_plain(xc, dc, h)
    if x.device.type != 'cuda':
        raise ValueError(f'no KDE kernel for device {x.device}')
    xc, dc = xc.contiguous(), dc.contiguous()
    rows, (n, d) = xc.shape[0], dc.shape
    out = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if rows == 0:
        return out
    from ._build import library
    lib = library()
    with torch.cuda.device(x.device):
        err = lib.nnueehcs_kde_logpdf_f32(
            xc.data_ptr(), rows, dc.data_ptr(), n, d,
            1.0 / (2.0 * h * h), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'KDE kernel launch failed: CUDA error {err}')
    kde_logpdf.launches += 1
    return out + _log_norm_const(n, d, h)


kde_logpdf.launches = 0


# --------------------------------------------------------------------------
# kNN-KDE: truncated KDE over the k nearest references
# --------------------------------------------------------------------------
# 'auto' exactness threshold of the JAX package (query x reference pairs).
# The port always runs the exact top-k; the setting only round-trips.
KNN_EXACT_AUTO_PAIRS = 1 << 26


def resolve_knn_exact(exact, b: int, n: int) -> bool:
    """Resolve a ``knn_exact`` setting (True/False/'auto'/None) for a
    (queries=b) x (references=n) problem, as the JAX package does."""
    if exact is None or exact == 'auto':
        return b * n <= KNN_EXACT_AUTO_PAIRS
    return bool(exact)


def knn_sq_dists(x, data, k: int, chunk: int = 4096):
    """(B, k) smallest squared distances, ascending, with ``k = min(k, N)``.
    Exact: both sides are centred, then one top-k when ``N <= chunk``, else
    a running merge of each chunk's distances into the best k so far.
    Queries go in tiles that keep each (rows, chunk + k) buffer near
    1 GiB."""
    xc, dc = centre(x, data)
    n = dc.shape[0]
    k = min(int(k), n)
    if n <= chunk:
        return _by_row_tiles(lambda xt: torch.topk(
            _sq_dists(xt, dc), k, dim=1, largest=False).values, xc, n)

    def merge(xt):
        best = torch.full((xt.shape[0], k), math.inf, dtype=xt.dtype,
                          device=xt.device)
        for start in range(0, n, chunk):
            merged = torch.cat([best, _sq_dists(xt, dc[start:start + chunk])],
                               dim=1)
            best = torch.topk(merged, k, dim=1, largest=False).values
        return best
    return _by_row_tiles(merge, xc, chunk + k)


def knn_kde_density(x, data, h: float, k: int):
    """Gaussian-kernel density truncated to the k nearest references, with
    the normalising constant over the whole corpus (it tends to the exact
    KDE as ``k -> N``)."""
    n, d = data.shape
    sqd = knn_sq_dists(x, data, k)
    gamma = 1.0 / (2.0 * h * h)
    return torch.exp(torch.logsumexp(-sqd * gamma, dim=1)
                     + _log_norm_const(n, d, h))
