"""The port's ``Trainer`` takes its device from ``trainer_config['accelerator']``
as the JAX trainer does (``nnueehcs_tpu/training/trainer.py`` ``_device``):
``'cpu'`` trains on the CPU, ``'auto'``, ``'gpu'`` and ``'cuda'`` on the card;
an explicit ``device`` wins over the latter, and ``'cpu'`` with a CUDA
``device`` is a conflict."""
import os

import numpy as np
import pytest
import torch
import yaml

import nnueehcs_tpu.training.trainer as jax_trainer
from nnueehcs_tpu.training import Trainer as JaxTrainer
from nnueehcs_tpu_torch.model_builder import EnsembleModelBuilder
from nnueehcs_tpu_torch.training import ArrayDataset, DataLoader, Trainer
from nnueehcs_tpu_torch.training import trainer as port_trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(
    os.path.join(REPO, 'examples', 'bo_driven', f)
    for f in os.listdir(os.path.join(REPO, 'examples', 'bo_driven'))
    if f.startswith('config') and f.endswith('.yaml'))


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


@pytest.fixture
def fake_card(monkeypatch):
    """``resolve_device`` as on a host with a card: a CUDA device is
    returned, not checked."""
    monkeypatch.setattr(port_trainer, 'resolve_device', torch.device)


def _fit(tmp_path, config, **kw):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 5)).astype(np.float32)
    y = np.sin(x).sum(1, keepdims=True).astype(np.float32)
    model = EnsembleModelBuilder(
        [{'Linear': {'args': [5, 16]}}, {'BatchNorm1d': {'args': [16]}},
         {'ReLU': {}}, {'Linear': {'args': [16, 1]}}],
        {'num_models': 2}, device='cpu').build()
    tr = Trainer('t', dict(config, max_epochs=1), log_dir=str(tmp_path), **kw)
    tr.fit(model, DataLoader(ArrayDataset(x, y), 16, drop_last=True))
    return tr, model


def test_accelerator_cpu_trains_on_the_cpu_without_a_card(no_card, tmp_path):
    tr, model = _fit(tmp_path, {'accelerator': 'cpu'})
    assert tr.device == torch.device('cpu')
    assert tr.global_step == 4 and np.isfinite(tr.callback_metrics['val_loss'])
    assert all(p.device.type == 'cpu' for p in model.net.parameters())


@pytest.mark.parametrize('accelerator', ['auto', 'gpu', 'cuda'])
def test_card_accelerators_resolve_to_cuda(fake_card, tmp_path, accelerator):
    tr = Trainer('t', {'accelerator': accelerator}, log_dir=str(tmp_path))
    assert tr.device.type == 'cuda'


@pytest.mark.parametrize('config', [{}, {'accelerator': 'auto'},
                                    {'accelerator': 'gpu'},
                                    {'accelerator': 'cuda'}])
def test_card_accelerators_raise_without_a_card(no_card, tmp_path, config):
    with pytest.raises(RuntimeError, match='cuda'):
        Trainer('t', config, log_dir=str(tmp_path))


@pytest.mark.parametrize('accelerator', ['auto', 'gpu', 'cuda'])
def test_explicit_cpu_device_wins(no_card, tmp_path, accelerator):
    tr, _ = _fit(tmp_path, {'accelerator': accelerator}, device='cpu')
    assert tr.device == torch.device('cpu')


@pytest.mark.parametrize('device', ['cuda', 'cuda:0', torch.device('cuda')])
def test_cpu_accelerator_with_a_cuda_device_is_a_conflict(fake_card, tmp_path,
                                                          device):
    with pytest.raises(ValueError, match='conflicts'):
        Trainer('t', {'accelerator': 'cpu'}, log_dir=str(tmp_path),
                device=device)


@pytest.mark.parametrize('path', CONFIGS, ids=os.path.basename)
def test_committed_configs_resolve_as_the_jax_trainer(fake_card, monkeypatch,
                                                      tmp_path, path):
    """Each committed BO config's trainer section: the JAX trainer's
    ``_device`` (its default backend stands for the card) and the port's
    device are the same kind."""
    with open(path) as f:
        section = yaml.safe_load(f)['trainer']
    monkeypatch.setattr(jax_trainer.jax, 'devices',
                        lambda backend=None: ['host' if backend == 'cpu'
                                              else 'card'])
    for cfg in (section, dict(section, accelerator='cpu')):
        want = JaxTrainer('t', dict(cfg), log_dir=str(tmp_path / 'j'),
                          version=0)._device()
        got = Trainer('t', dict(cfg), log_dir=str(tmp_path / 'p'),
                      version=0).device
        assert {'host': 'cpu', 'card': 'cuda'}[want] == got.type
