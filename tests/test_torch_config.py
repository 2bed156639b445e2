"""The port's reader of the configs' YAML subset
(``nnueehcs_tpu_torch/config.py``) against ``yaml.safe_load``: equal on
every committed config and on small documents of the subset, and raising
on documents outside it."""
import io
import os

import pytest
import yaml

from nnueehcs_tpu_torch import config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = ['examples/binomial_options/config.yaml',
             'examples/bo_driven/config.yaml',
             'examples/bo_driven/config_full.yaml',
             'examples/bo_driven/config_full_bf16eval.yaml',
             'examples/bo_driven/config_kde.yaml',
             'experiments/grid_r4/config_mesh_airfoil.yaml',
             'experiments/grid_r5/config_kde_full_scale.yaml']


def test_the_list_is_every_committed_config():
    import glob
    found = sorted(os.path.relpath(p, REPO) for p in
                   glob.glob(os.path.join(REPO, 'examples', '**', '*.yaml'),
                             recursive=True))
    assert found == sorted(c for c in COMMITTED if c.startswith('examples'))


@pytest.mark.parametrize('path', COMMITTED)
def test_committed_config_reads_as_pyyaml_reads_it(path):
    full = os.path.join(REPO, path)
    with open(full) as f:
        want = yaml.safe_load(f)
    assert config.load_path(full) == want
    with open(full) as f:                       # a file object, as a stream
        assert config.safe_load(f) == want


@pytest.mark.parametrize('text', [
    'a: 1',
    'a: -3\nb: +4\nc: 5.\nd: -1.5e+3\ne: 5.0e-05\nf: 0',
    '- 1\n- x\n- true\n- false\n- null',
    'a:\n- b: 1\n  c: [1, \'x, y\', 2.5]\n- 2',
    'a:\n  - b:\n      c: []\n  - d',
    '- ReLU: {}\n- Linear:\n    args: [5, 1]',
    "a: 'it''s'\nb: \"double\" # comment\n# whole line\nc: x#not-a-comment",
    'a: "\\t"\nb: "q\\"\\\\ # not a comment"\nc: "\\n\\r\\0\\/"',
    'a:\nb:\n  c:',
    'x',
    '',
    '---\nk: a:b\nl: \\s+\nm: bf16-mixed\nn: examples/data/x.h5',
    'outer:\n  inner:\n  - name: p\n    type: range\n    bounds:\n    - 2\n    - 32',
])
def test_subset_documents_read_as_pyyaml_reads_them(text):
    assert config.safe_load(text) == yaml.safe_load(text)
    assert config.safe_load(io.StringIO(text)) == yaml.safe_load(text)


@pytest.mark.parametrize('text', [
    'a: &x 1',                    # anchor
    'a: *x',                      # alias
    'a: !!str 1',                 # tag
    'a: |\n  x',                  # block scalar
    'a: >\n  x',
    'a: {b: 1}',                  # flow mapping
    'a: [[1]]',                   # nested flow sequence
    'a: [1',                      # unterminated flow sequence
    'a: yes',                     # YAML 1.1 booleans and nulls PyYAML resolves
    'a: True',
    'a: ~',
    'a: 1e-5',                    # PyYAML reads this as a string
    'a: 0x10',
    'a: 010',
    'a: .inf',
    'a: 1:30',
    'a: 1_000',
    'a: 1\na: 2',                 # duplicate key
    'a: b\n  c',                  # multi-line plain scalar
    '---\na: 1\n---\nb: 2',       # two documents
    'a: "x\\x41"',                # an escape outside the subset
    'a: "x\\u0041"',
    'a:\n\t- 1',                  # tab indentation
    'a: b: c',
    "a: 'open",
    '- - 1',
    'a: 1\n  b: 2',
])
def test_documents_outside_the_subset_raise(text):
    with pytest.raises(config.ConfigError, match='line'):
        config.safe_load(text)
