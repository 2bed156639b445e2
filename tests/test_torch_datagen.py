"""The port's dataset generators and writers (``nnueehcs_tpu_torch/
datagen.py``) against the JAX package's: the same arrays bit for bit for
the same ``n`` and seed, the same files, and files the JAX package's
readers read back."""
import os

import numpy as np
import pytest

from nnueehcs_tpu import data_utils as jax_data
from nnueehcs_tpu import datagen as jax_datagen
from nnueehcs_tpu_torch import datagen

GENERATORS = sorted(jax_datagen.GENERATORS)


def test_same_generators():
    assert sorted(datagen.GENERATORS) == GENERATORS


@pytest.mark.parametrize('name', GENERATORS)
@pytest.mark.parametrize('seed', [None, 7])
def test_generator_is_bit_equal(name, seed):
    kwargs = {} if seed is None else {'seed': seed}
    got = datagen.GENERATORS[name](257, **kwargs)
    want = jax_datagen.GENERATORS[name](257, **kwargs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        assert g.shape == w.shape
        assert np.array_equal(g, w)


def test_binomial_pricer_chunks_and_steps_are_bit_equal():
    got = datagen.generate_binomial_options(300, seed=3, steps=16, chunk=64)
    want = jax_datagen.generate_binomial_options(300, seed=3, steps=16,
                                                 chunk=64)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    s = np.array([10.0, 20.0])
    args = (s, np.array([12.0, 15.0]), np.array([0.02, 0.03]),
            np.array([0.07, 0.09]), np.array([1.0, 4.0]))
    assert np.array_equal(datagen.binomial_option_price(*args, steps=32),
                          jax_datagen.binomial_option_price(*args, steps=32))


@pytest.fixture(scope='module')
def arrays():
    return datagen.generate_airfoil(203, seed=5)


def test_hdf5_written_by_the_port_reads_in_jax(arrays, tmp_path):
    ipt, opt = arrays
    path = str(tmp_path / 'd.h5')
    datagen.write_hdf5(path, ipt, opt, 'Kernel')
    ds = jax_data.HDF5Dataset(path, 'Kernel', 'input', 'output')
    assert np.array_equal(ds.input, ipt) and np.array_equal(ds.output, opt)


@pytest.mark.parametrize('writer', ['arff', 'delimited_tab',
                                    'delimited_comma'])
def test_text_files_match_jax_and_read_back(arrays, tmp_path, writer):
    ipt, opt = arrays
    ours, theirs = str(tmp_path / 'ours'), str(tmp_path / 'theirs')
    if writer == 'arff':
        datagen.write_arff(ours, ipt, opt, 'rel')
        jax_datagen.write_arff(theirs, ipt, opt, 'rel')
        ds = jax_data.ARFFDataSet(ours)
    else:
        delim = '\t' if writer == 'delimited_tab' else ','
        datagen.write_delimited(ours, ipt, opt, delim)
        jax_datagen.write_delimited(theirs, ipt, opt, delim)
        ds = jax_data.CharacterDelimitedDataset(ours, delim)
    with open(ours, 'rb') as a, open(theirs, 'rb') as b:
        assert a.read() == b.read()
    # 7 significant digits in the text
    np.testing.assert_allclose(ds.input, ipt, rtol=1e-6, atol=0)
    np.testing.assert_allclose(ds.output, opt, rtol=1e-6, atol=0)


def test_benchmark_files_match_jax(tmp_path):
    sizes = {'binomial_options': 64, 'minibude': 50, 'ailerons': 40,
             'airfoil': 30, 'puma': 20}
    ours = datagen.generate_benchmark_files(str(tmp_path / 'ours'), sizes,
                                            steps=8)
    theirs = jax_datagen.generate_benchmark_files(str(tmp_path / 'theirs'),
                                                  sizes, steps=8)
    assert sorted(ours) == sorted(theirs)
    for name in ours:
        assert os.path.basename(ours[name]) == os.path.basename(theirs[name])
        if ours[name].endswith('.h5'):
            group = {'binomial_options': 'BinomialOptionsKernel',
                     'minibude': 'BUDEKernel'}[name]
            a = jax_data.HDF5Dataset(ours[name], group, 'input', 'output')
            b = jax_data.HDF5Dataset(theirs[name], group, 'input', 'output')
            assert np.array_equal(a.input, b.input)
            assert np.array_equal(a.output, b.output)
        else:
            with open(ours[name], 'rb') as f, open(theirs[name], 'rb') as g:
                assert f.read() == g.read()
