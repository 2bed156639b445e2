"""Benchmark dataset generation.

Counterpart of ``nnueehcs_tpu/datagen.py``, numpy only, with the same
arrays for the same ``n`` and seed (bit for bit): the real
Cox-Ross-Rubinstein binomial-tree European call pricer over 5 inputs
(``binomial_options``) and the smooth synthetic stand-ins ``minibude``
(6 inputs), ``ailerons`` (40), ``airfoil`` (5) and ``puma`` (8), with the
shapes, formats and config schema of the reference's datasets, which are
not redistributable. Each generator returns ``(inputs, outputs)`` float32
arrays; the writers emit HDF5 (``h5py``, imported when called), ARFF and
delimited files that :mod:`nnueehcs_tpu_torch.data_utils` reads. On a
machine without ``h5py``, write the delimited form.
"""
from __future__ import annotations

import os

import numpy as np


# ---------------------------------------------------------------------------
# binomial options: the real kernel
# ---------------------------------------------------------------------------
def binomial_option_price(spot, strike, rate, vol, expiry,
                          steps: int = 64) -> np.ndarray:
    """Vectorised CRR binomial-tree European call pricing."""
    spot = np.asarray(spot, np.float64)
    dt = np.asarray(expiry, np.float64) / steps
    u = np.exp(np.asarray(vol, np.float64) * np.sqrt(dt))
    d = 1.0 / u
    disc = np.exp(-np.asarray(rate, np.float64) * dt)
    p = (np.exp(np.asarray(rate, np.float64) * dt) - d) / (u - d)

    j = np.arange(steps + 1)
    # leaf prices: S * u^j * d^(steps-j)
    leaf = spot[:, None] * u[:, None] ** j[None, :] * \
        d[:, None] ** (steps - j)[None, :]
    values = np.maximum(leaf - np.asarray(strike, np.float64)[:, None], 0.0)

    for _ in range(steps):
        values = disc[:, None] * (p[:, None] * values[:, 1:]
                                  + (1 - p[:, None]) * values[:, :-1])
    return values[:, 0]


def generate_binomial_options(n: int, seed: int = 0, steps: int = 64,
                              chunk: int = 65536):
    """5 inputs (S, K, r, v, T) → European call price."""
    rng = np.random.default_rng(seed)
    spot = rng.uniform(5.0, 30.0, n)
    strike = rng.uniform(1.0, 100.0, n)
    rate = rng.uniform(0.01, 0.05, n)
    vol = rng.uniform(0.05, 0.10, n)
    expiry = rng.uniform(0.25, 10.0, n)
    out = np.empty(n, np.float64)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        out[lo:hi] = binomial_option_price(
            spot[lo:hi], strike[lo:hi], rate[lo:hi], vol[lo:hi],
            expiry[lo:hi], steps=steps)
    inputs = np.stack([spot, strike, rate, vol, expiry], axis=1)
    return inputs.astype(np.float32), out[:, None].astype(np.float32)


# ---------------------------------------------------------------------------
# synthetic stand-ins with matching dimensionality
# ---------------------------------------------------------------------------
def _smooth_response(x: np.ndarray, seed: int) -> np.ndarray:
    """A smooth random nonlinear scalar field: random sinusoidal features +
    a quadratic bowl, giving output tails suitable for percentile splits."""
    rng = np.random.default_rng(seed)
    d = x.shape[1]
    w = rng.normal(size=(d, 8))
    phases = rng.uniform(0, 2 * np.pi, 8)
    amps = rng.uniform(0.5, 1.5, 8)
    proj = x @ w
    y = (np.sin(proj + phases) * amps).sum(axis=1)
    y = y + 0.5 * np.sum(x * x, axis=1)
    return y[:, None]


def generate_minibude(n: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5, 1.5, size=(n, 6))
    return x.astype(np.float32), _smooth_response(x, seed).astype(np.float32)


def generate_ailerons(n: int, seed: int = 2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 40))
    return x.astype(np.float32), _smooth_response(x, seed).astype(np.float32)


def generate_airfoil(n: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, size=(n, 5))
    return x.astype(np.float32), _smooth_response(x, seed).astype(np.float32)


def generate_puma(n: int, seed: int = 4):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-np.pi / 2, np.pi / 2, size=(n, 8))
    return x.astype(np.float32), _smooth_response(x, seed).astype(np.float32)


GENERATORS = {
    'binomial_options': generate_binomial_options,
    'minibude': generate_minibude,
    'ailerons': generate_ailerons,
    'airfoil': generate_airfoil,
    'puma': generate_puma,
}


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------
def write_hdf5(path, inputs, outputs, group_name):
    import h5py
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    with h5py.File(path, 'w') as f:
        g = f.create_group(group_name)
        g.create_dataset('input', data=inputs)
        g.create_dataset('output', data=outputs)


def write_arff(path, inputs, outputs, relation='data'):
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    with open(path, 'w') as f:
        f.write(f'@RELATION {relation}\n')
        for i in range(inputs.shape[1]):
            f.write(f'@ATTRIBUTE f{i} NUMERIC\n')
        f.write('@ATTRIBUTE target NUMERIC\n@DATA\n')
        for row_in, row_out in zip(inputs, outputs):
            f.write(','.join(f'{v:.7g}' for v in row_in)
                    + f',{row_out[0]:.7g}\n')


def write_delimited(path, inputs, outputs, delimiter='\t'):
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    data = np.concatenate([inputs, outputs], axis=1)
    np.savetxt(path, data, delimiter=delimiter, fmt='%.7g')


def generate_benchmark_files(data_dir: str, sizes: dict | None = None,
                             steps: int = 64) -> dict:
    """Generate all benchmark files under ``data_dir``; returns
    name → path."""
    sizes = sizes or {}
    paths = {}

    ipt, opt = generate_binomial_options(sizes.get('binomial_options', 262144),
                                         steps=steps)
    p = os.path.join(data_dir, 'binomial_options.h5')
    write_hdf5(p, ipt, opt, 'BinomialOptionsKernel')
    paths['binomial_options'] = p

    ipt, opt = generate_minibude(sizes.get('minibude', 65536))
    p = os.path.join(data_dir, 'bude_train.h5')
    write_hdf5(p, ipt, opt, 'BUDEKernel')
    paths['minibude'] = p

    ipt, opt = generate_ailerons(sizes.get('ailerons', 13750))
    p = os.path.join(data_dir, 'ailerons.arff')
    write_arff(p, ipt, opt, 'ailerons')
    paths['ailerons'] = p

    ipt, opt = generate_airfoil(sizes.get('airfoil', 1503))
    p = os.path.join(data_dir, 'airfoil_self_noise.dat')
    write_delimited(p, ipt, opt, '\t')
    paths['airfoil'] = p

    ipt, opt = generate_puma(sizes.get('puma', 8192))
    p = os.path.join(data_dir, 'puma.data')
    write_delimited(p, ipt, opt, '\t')
    paths['puma'] = p

    return paths
