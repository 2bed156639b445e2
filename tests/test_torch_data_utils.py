"""The port's dataset layer (``nnueehcs_tpu_torch/data_utils.py`` and the
native parser in ``nnueehcs_tpu_torch/native``) against the JAX package's:
every reader gives the JAX package's arrays, every percentile string of
the committed configs partitions the same rows, ``train_test_split``
selects the same rows and the scaling gives the same values."""
import glob
import io
import os

import numpy as np
import pytest
import torch
import yaml

from nnueehcs_tpu import data_utils as jax_data
from nnueehcs_tpu import datagen as jax_datagen
from nnueehcs_tpu_torch import data_utils, native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, 'examples', '**', '*.yaml'),
                           recursive=True)) + [
    os.path.join(REPO, 'experiments', 'grid_r4', 'config_mesh_airfoil.yaml'),
    os.path.join(REPO, 'experiments', 'grid_r5', 'config_kde_full_scale.yaml')]


def _percentile_strings():
    found = set()

    def walk(node):
        if isinstance(node, dict):
            for k, v in node.items():
                if k == 'percentiles':
                    found.add(v)
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)
    for path in CONFIGS:
        with open(path) as f:
            walk(yaml.safe_load(f))
    return sorted(found)


PERCENTILES = _percentile_strings()


def assert_same(ours, theirs):
    for a, b in ((ours.input, theirs.input), (ours.output, theirs.output)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


@pytest.fixture(scope='module')
def table():
    """Airfoil-like rows with ties in the output (quantile edges)."""
    ipt, opt = jax_datagen.generate_airfoil(517, seed=11)
    opt[::7] = opt[3]
    return ipt, opt


@pytest.fixture(scope='module')
def files(table, tmp_path_factory):
    tmp = tmp_path_factory.mktemp('data')
    ipt, opt = table
    paths = {'hdf5': str(tmp / 'd.h5'), 'arff': str(tmp / 'd.arff'),
             'tab': str(tmp / 'd.tsv'), 'space': str(tmp / 'd.dat'),
             'comma': str(tmp / 'd.csv'), 'header': str(tmp / 'h.csv')}
    jax_datagen.write_hdf5(paths['hdf5'], ipt, opt, 'G')
    jax_datagen.write_arff(paths['arff'], ipt, opt)
    jax_datagen.write_delimited(paths['tab'], ipt, opt, '\t')
    jax_datagen.write_delimited(paths['space'], ipt, opt, ' ')
    jax_datagen.write_delimited(paths['comma'], ipt, opt, ',')
    with open(paths['header'], 'w') as f:
        f.write('a,b,c,d,e,target\n')
        with open(paths['comma']) as g:
            f.write(g.read())
    return paths


READERS = {
    'hdf5': ('hdf5', lambda p: {'group_name': 'G', 'input_dataset': 'input',
                                'output_dataset': 'output'}),
    'arff': ('arff', lambda p: {}),
    'tab': ('character_delimited', lambda p: {'delimiter': '\t'}),
    'space': ('character_delimited', lambda p: {'delimiter': r'\s+'}),
    'comma': ('character_delimited', lambda p: {'delimiter': ','}),
    'header': ('character_delimited', lambda p: {'delimiter': ','}),
}


def both(config, name='ds'):
    return (data_utils.get_dataset_from_config(config, name),
            jax_data.get_dataset_from_config(config, name))


@pytest.mark.parametrize('kind', sorted(READERS))
def test_every_reader_gives_the_jax_arrays(files, kind):
    fmt, extra = READERS[kind]
    cfg = {'ds': {'format': fmt, 'path': files[kind],
                  **extra(files[kind])}}
    ours, theirs = both(cfg)
    assert_same(ours, theirs)
    if fmt == 'character_delimited':
        assert ours.parser == 'native'


@pytest.mark.parametrize('kind', ['tab', 'space', 'comma', 'header'])
def test_numpy_parsed_delimited_gives_the_jax_arrays(files, kind,
                                                     monkeypatch):
    """Without the native parser (a file object, or no library), the port
    parses with numpy where the JAX package uses pandas."""
    _, extra = READERS[kind]
    delim = extra(None)['delimiter']
    with open(files[kind]) as f:
        text = f.read()
    ours = data_utils.CharacterDelimitedDataset(io.StringIO(text), delim)
    theirs = jax_data.CharacterDelimitedDataset(io.StringIO(text), delim)
    assert ours.parser == 'numpy'
    assert_same(ours, theirs)
    monkeypatch.setattr(native, 'library', lambda: None)
    ours = data_utils.CharacterDelimitedDataset(files[kind], delim)
    assert ours.parser == 'numpy'
    assert_same(ours, theirs)


def test_native_parser_counts_its_reads_and_declines_non_numeric(tmp_path,
                                                                 files):
    before = native.load_delimited.native_reads
    arr = native.load_delimited(files['tab'], '\t')
    assert arr.shape == (517, 6)
    assert native.load_delimited.native_reads == before + 1
    bad = tmp_path / 'bad.csv'
    bad.write_text('1,2,3\n4,x,6\n')
    assert native.load_delimited(str(bad), ',') is None
    assert native.load_delimited(str(bad), 'X') is None       # unknown
    assert native.load_delimited.native_reads == before + 1
    assert str(native.BUILD_DIR).startswith(REPO)


@pytest.mark.parametrize('percentiles', PERCENTILES)
@pytest.mark.parametrize('kind', ['hdf5', 'tab'])
def test_committed_percentiles_partition_the_same_rows(files, percentiles,
                                                        kind):
    fmt, extra = READERS[kind]
    cfg = {'ds': {'format': fmt, 'path': files[kind], 'dtype': 'float32',
                  'percentiles': percentiles, **extra(files[kind])}}
    ours, theirs = both(cfg)
    assert len(ours) > 0
    assert_same(ours, theirs)


def test_the_configs_name_the_grid_splits():
    assert {'[0, 70]', '[70, 100]', '[0, 30], [60, 100]',
            '[30, 60]'} <= set(PERCENTILES)


def test_slice_then_partition_then_dtype(files):
    cfg = {'ds': {'format': 'hdf5', 'path': files['hdf5'],
                  'group_name': 'G', 'input_dataset': 'input',
                  'output_dataset': 'output', 'percentiles': '[20, 90]',
                  'subset': {'start': 5, 'stop': 400, 'step': 3},
                  'dtype': 'float64'}}
    ours, theirs = both(cfg)
    assert ours.dtype == np.float64
    assert_same(ours, theirs)


@pytest.mark.parametrize('seed', [0, 3])
def test_train_test_split_selects_the_same_rows(files, seed):
    cfg = {'ds': {'format': 'hdf5', 'path': files['hdf5'],
                  'group_name': 'G', 'input_dataset': 'input',
                  'output_dataset': 'output'}}
    ours, theirs = both(cfg)
    for a, b in zip(ours.train_test_split(0.2, seed),
                    theirs.train_test_split(0.2, seed)):
        assert np.array_equal(a.indices, b.indices)
        assert np.array_equal(a.input, b.input)
        assert len(a) == len(b)


def test_scaling_matches_with_ood_scaled_by_id_statistics(files):
    base = {'format': 'hdf5', 'path': files['hdf5'], 'group_name': 'G',
            'input_dataset': 'input', 'output_dataset': 'output',
            'dtype': 'float32'}
    cfg = {'tails_id': dict(base, percentiles='[0, 70]'),
           'tails_ood': dict(base, percentiles='[70, 100]')}
    out = []
    for pkg in (data_utils, jax_data):
        dset_id = pkg.get_dataset(cfg, 'tails')
        dset_ood = pkg.prepare_dataset_for_use(
            pkg.get_dataset(cfg, 'tails', is_ood=True), {'scaling': True},
            scaling_dset=dset_id)
        out.append((pkg.prepare_dataset_for_use(dset_id, {'scaling': True}),
                    dset_ood))
    (id_o, ood_o), (id_t, ood_t) = out
    assert_same(id_o, id_t)
    assert_same(ood_o, ood_t)
    # OOD outputs lie above the ID range: scaled by ID statistics they
    # pass 1
    assert float(np.asarray(ood_o.output).max()) > 1.0
    unscaled = data_utils.get_dataset(cfg, 'tails')
    same = data_utils.prepare_dataset_for_use(unscaled, {'scaling': False})
    assert np.array_equal(same.input, jax_data.get_dataset(cfg, 'tails').input)


def test_read_dataset_from_yaml_reads_a_stream_and_a_path(files, tmp_path):
    text = (f"datasets:\n  b_id:\n    format: character_delimited\n"
            f"    delimiter: ','\n    path: {files['comma']}\n"
            f"    percentiles: '[0, 70]'\n")
    ours = data_utils.read_dataset_from_yaml(io.StringIO(text), 'b_id')
    theirs = jax_data.read_dataset_from_yaml(io.StringIO(text), 'b_id')
    assert_same(ours, theirs)
    path = tmp_path / 'c.yaml'
    path.write_text(text)
    assert_same(data_utils.read_dataset_from_yaml(str(path), 'b_id'), theirs)
    with pytest.raises(ValueError, match='Unknown dataset format'):
        data_utils.get_dataset_from_config({'x': {'format': 'npz'}}, 'x')


def test_to_device_gives_torch_tensors(files):
    cfg = {'ds': {'format': 'arff', 'path': files['arff'],
                  'dtype': 'float32'}}
    ds = data_utils.get_dataset_from_config(cfg, 'ds')
    host = np.asarray(ds.input).copy()
    ds.to('cpu')
    assert isinstance(ds.input, torch.Tensor) and ds.input.device.type == 'cpu'
    assert np.array_equal(ds.input.numpy(), host)
    assert ds.to(None) is ds
