"""The port's data generator (``nnueehcs_tpu_torch/examples/data/
generate_data.py``) and single-run KDE example
(``nnueehcs_tpu_torch/examples/binomial_options/bo.py``) against the JAX
scripts, and the config writer (``nnueehcs_tpu_torch.config.dump``) against
PyYAML: the same data files bit for bit at a small ``--size``; configs that
``yaml.safe_load`` and the port's reader both read back as the JAX script's
dict; the example's Wasserstein distance on the JAX script's own bundle
within 1e-5."""
import ast
import importlib.util
import io
import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml
from click.testing import CliRunner

from nnueehcs_tpu_torch import config, datagen
from nnueehcs_tpu_torch.examples.binomial_options import bo as bo_example
from nnueehcs_tpu_torch.examples.data import generate_data

from test_torch_config import COMMITTED
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5


def load_script(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_generate_data_matches_the_jax_script(tmp_path):
    jax_script = load_script(REPO / 'examples' / 'data' / 'generate_data.py',
                             'jax_generate_data')
    dirs = {name: tmp_path / name for name in ('jax', 'port')}
    args = {name: ['--data-dir', str(d), '--size', '300', '--steps', '8',
                   '--write-config', str(d / 'config.yaml'),
                   '--write-kde-config', str(d / 'kde' / 'config.yaml')]
            for name, d in dirs.items()}
    res = CliRunner().invoke(jax_script.main, args['jax'])
    assert res.exit_code == 0, res.output
    assert generate_data.main(args['port']) == 0
    files = sorted(p.name for p in dirs['jax'].iterdir() if p.is_file())
    assert sorted(p.name for p in dirs['port'].iterdir() if p.is_file()) \
        == files
    assert len(files) == 6
    for name in files:
        if name == 'config.yaml':
            continue
        assert (dirs['port'] / name).read_bytes() == \
            (dirs['jax'] / name).read_bytes(), name
    for rel in ('config.yaml', 'kde/config.yaml'):
        text = (dirs['port'] / rel).read_text().replace(str(dirs['port']),
                                                        str(dirs['jax']))
        want = yaml.safe_load((dirs['jax'] / rel).read_text())
        assert yaml.safe_load(text) == want
        assert config.safe_load(text) == want


def test_generate_data_needs_h5py_for_its_hdf5_files(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'h5py', None)
    with pytest.raises(ImportError):
        generate_data.main(['--data-dir', str(tmp_path), '--size', '50',
                            '--steps', '4'])


@pytest.mark.parametrize('path', COMMITTED)
def test_dump_round_trips_committed_configs(path):
    with open(REPO / path) as f:
        want = yaml.safe_load(f)
    text = config.dump(want)
    assert yaml.safe_load(text) == want
    assert config.safe_load(text) == want


VALUES = {
    'quotes': "it's", 'tab': '\t', 'newline': 'a\nb', 'flow': '[0, 70]',
    'regex': r'\s+', 'empty': '', 'true_word': 'true', 'yes_word': 'yes',
    'null_word': 'null', 'number_word': '10', 'exp_word': '1e-5',
    'leading_space': ' x', 'colon': 'a: b', 'dash': '-x', 'hash': 'x #y',
    'small_float': 5e-05, 'big_float': 1e20, 'negative': -3,
    'float_int': 100.0, 'none': None, 'bool': False,
    'nested': [[1, 2], [], {}, {'a': [{'b': None}]}],
    'empty_map': {}, 'empty_list': [],
}


@pytest.mark.parametrize('key', sorted(VALUES))
def test_dump_round_trips_subset_values(key):
    doc = {'section': {key: VALUES[key], 'after': 1}, 'list': [VALUES[key]]}
    text = config.dump(doc)
    assert yaml.safe_load(text) == doc
    assert config.safe_load(text) == doc


@pytest.mark.parametrize('value', [math.nan, math.inf, {1: 'a'}, {'a'},
                                   'bell\x07', b'bytes', (1, 2)],
                         ids=['nan', 'inf', 'int_key', 'set', 'control',
                              'bytes', 'tuple'])
def test_dump_refuses_what_the_subset_lacks(value):
    with pytest.raises(config.ConfigError):
        config.dump({'key': value})


def test_dump_writes_a_stream():
    stream = io.StringIO()
    assert config.dump({'a': [1, 'b']}, stream) is None
    assert stream.getvalue() == 'a:\n- 1\n- b\n'


# ---------------------------------------------------------------------------
# the single-run KDE example
# ---------------------------------------------------------------------------
@pytest.fixture(scope='module')
def kde_config(tmp_path_factory):
    """examples/binomial_options/config.yaml cut to one epoch of a 5-16-1
    net on 2,000 rows of the options kernel."""
    tmp = tmp_path_factory.mktemp('kde')
    ipt, opt = datagen.generate_binomial_options(2000)
    datagen.write_hdf5(str(tmp / 'bo.h5'), ipt, opt, 'BinomialOptionsKernel')
    with open(REPO / 'examples' / 'binomial_options' / 'config.yaml') as f:
        cfg = yaml.safe_load(f)
    cfg['trainer'].update(max_epochs=1, accelerator='cpu')
    cfg['training']['batch_size'] = 256
    cfg['model']['architecture'] = [{'Linear': {'args': [5, 16]}},
                                    {'ReLU': {}},
                                    {'Linear': {'args': [16, 1]}}]
    for entry in cfg['datasets'].values():
        entry['path'] = str(tmp / 'bo.h5')
    path = tmp / 'config.yaml'
    path.write_text(yaml.safe_dump(cfg))
    return str(path), cfg


def printed_result(output):
    line = next(l for l in output.splitlines()
                if l.startswith("{'wasserstein_distance'"))
    return ast.literal_eval(line)


def test_kde_example_scores_the_jax_bundle_as_jax(kde_config, tmp_path,
                                                  monkeypatch):
    """The JAX script trains and scores; the port's ``--eval_only`` scores
    the bundle it wrote to the same Wasserstein distance and draws the
    same figure file."""
    path, cfg = kde_config
    monkeypatch.chdir(tmp_path)
    jax_script = load_script(REPO / 'examples' / 'binomial_options' / 'bo.py',
                             'jax_binomial_options')
    res = CliRunner().invoke(jax_script.main, ['--config', path])
    assert res.exit_code == 0, res.output
    want = printed_result(res.output)
    os.remove('uncertainty.png')
    got, id_ue, ood_ue = bo_example.run(cfg, eval_only=True, device='cpu')
    assert abs(got['wasserstein_distance']
               - want['wasserstein_distance']) <= TOL
    assert os.path.isfile('uncertainty.png')
    assert id_ue.ndim == ood_ue.ndim == 1
    assert len(id_ue) + len(ood_ue) == 2000
    assert np.isfinite(got['wasserstein_distance'])


def test_kde_example_trains_on_the_cpu_when_asked(kde_config, tmp_path,
                                                  monkeypatch):
    path, _ = kde_config
    monkeypatch.chdir(tmp_path)
    assert bo_example.main(['--config', path, '--device', 'cpu',
                            '--log_dir', 'runs', '--no_plots']) == 0
    run_dir = Path('runs') / 'binomial_options' / 'version_0'
    assert sorted(os.listdir(run_dir)) == ['hparams.yaml', 'metrics.csv',
                                           'model.pth']
    assert not os.path.exists('uncertainty.png')
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    with pytest.raises(ImportError, match='matplotlib'):
        bo_example.main(['--config', path, '--device', 'cpu', '--log_dir',
                         'runs', '--eval_only'])
    got, _, _ = bo_example.run(bo_example.config_reader.load_path(path),
                               eval_only=True, log_dir='runs', device='cpu',
                               plots=False)
    assert np.isfinite(got['wasserstein_distance'])


def test_kde_example_eval_only_without_a_run_exits(kde_config, tmp_path,
                                                   monkeypatch):
    _, cfg = kde_config
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match='No trained model'):
        bo_example.run(cfg, eval_only=True, device='cpu')
