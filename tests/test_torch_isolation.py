"""The port stands alone: it imports with JAX, the JAX package and the
packages a CUDA-only machine lacks all blocked; its entry points refuse to
run on the CPU unless asked; and its kernels build with plain nvcc, not
PyTorch's extension builder."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import nnueehcs_tpu_torch
from nnueehcs_tpu_torch.model_builder import EnsembleModelBuilder
from nnueehcs_tpu_torch.ops import _build
from nnueehcs_tpu_torch.serving import Predictor
from nnueehcs_tpu_torch.training import load_model, save_model

from torch_parity import descr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ('jax', 'jaxlib', 'nnueehcs_tpu', 'yaml', 'pandas', 'h5py', 'ninja',
           'ml_dtypes', 'optax', 'orbax', 'sklearn', 'matplotlib', 'click')

_IMPORT_ALL = r'''
import importlib, importlib.abc, pkgutil, sys
BLOCKED = set(sys.argv[1].split(','))
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError(f'{name} is blocked')
        return None
for name in list(sys.modules):          # a site hook may have pre-imported some
    if name.split('.')[0] in BLOCKED:
        del sys.modules[name]
sys.meta_path.insert(0, Block())
import nnueehcs_tpu_torch
names = ['chip_smoke', 'nnueehcs_tpu_torch'] + [
    m.name for m in pkgutil.walk_packages(nnueehcs_tpu_torch.__path__,
                                          'nnueehcs_tpu_torch.')]
for name in names:
    importlib.import_module(name)
leaked = sorted(n for n in sys.modules if n.split('.')[0] in BLOCKED)
assert not leaked, leaked
print(len(names))
'''


def test_port_and_chip_smoke_import_with_heavy_packages_blocked():
    proc = subprocess.run(
        [sys.executable, '-c', _IMPORT_ALL, ','.join(BLOCKED)], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 24


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


@pytest.fixture
def cpu_model():
    return EnsembleModelBuilder(descr(), {'num_models': 2}, device='cpu').build()


def test_predictor_default_device_raises_without_card(no_card, cpu_model):
    with pytest.raises(RuntimeError, match='cuda'):
        Predictor(cpu_model)
    # nothing moved: the model is still usable on the CPU when asked
    mean, std = Predictor(cpu_model, device='cpu', warmup=False).predict(
        np.zeros((3, 5), np.float32))
    assert mean.shape == (3, 1)


def test_builder_and_loader_default_device_raise_without_card(
        no_card, cpu_model, tmp_path):
    with pytest.raises(RuntimeError, match='cuda'):
        EnsembleModelBuilder(descr(), {'num_models': 2}).build()
    path = str(tmp_path / 'model.pth')
    save_model(cpu_model, path)
    with pytest.raises(RuntimeError, match='cuda'):
        load_model(path)
    with pytest.raises(RuntimeError, match='cuda'):
        cpu_model.to('cuda')


def test_attrib_default_device_raises_without_card(no_card):
    from nnueehcs_tpu_torch import attrib
    for battery in ('forward', 'train'):
        with pytest.raises(RuntimeError, match='cuda'):
            attrib.main([battery])
    with pytest.raises(RuntimeError, match='cuda'):
        attrib.train_battery()
    with pytest.raises(RuntimeError, match='cuda'):
        attrib.forward_battery()


def test_kernels_build_with_plain_nvcc():
    headers = sorted(_build.CSRC.glob('*.cuh'))
    texts = [open(_build.__file__).read()] + \
        [src.read_text() for src in [*_build.sources(), *headers]]
    assert [s.name for s in _build.sources()] == [
        'ablate_chain.cu', 'ablate_train.cu', 'fused_anchored.cu',
        'fused_ensemble.cu', 'fused_mc_dropout.cu', 'fused_train.cu',
        'fused_train_bf16.cu', 'kde.cu']
    assert [h.name for h in headers] == ['fused_chain.cuh',
                                         'fused_chain_wgmma.cuh',
                                         'fused_train.cuh',
                                         'fused_train_cluster.cuh',
                                         'stamps.cuh']
    for text in texts:
        for banned in ('cpp_extension', 'torch/extension.h', 'ninja'):
            assert banned not in text
    flags = ' '.join(_build.NVCC_FLAGS)
    assert 'arch=compute_90a,code=sm_90a' in flags
    link = ' '.join(_build.LINK_FLAGS)
    assert 'arch=compute_90a,code=sm_90a' in link and '-shared' in link
    assert _build.BUILD_DIR == \
        __import__('pathlib').Path(REPO) / 'build' / 'nnueehcs_tpu_torch'
    assert os.path.dirname(nnueehcs_tpu_torch.__file__).startswith(REPO)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build.find_nvcc()
