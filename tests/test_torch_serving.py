"""The slice end to end: JAX-built and JAX-trained ensembles served by the
port's ``Predictor`` on the CPU, against the JAX model's own
``model(x, return_ue=True)``; and ``model.pth`` bundles read and written by
both packages. Tolerances: mean 1e-5 absolute and relative; std 1e-3
relative, 1e-5 absolute."""
import os
import pickle

import numpy as np
import pytest
import torch

from nnueehcs_tpu.model_builder import MLPModelBuilder as JaxMLPModelBuilder
from nnueehcs_tpu.training import load_model as jax_load_model
from nnueehcs_tpu.training import save_model as jax_save_model
from nnueehcs_tpu_torch.models import base
from nnueehcs_tpu_torch.serving import DEFAULT_BUCKETS, Predictor
from nnueehcs_tpu_torch.training import load_model, save_model

from torch_parity import TOL_MEAN, assert_ue_close, descr, jax_ensemble, port_of

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = os.path.join(REPO, 'experiments', 'full_cell', 'artifacts',
                       'puma_ensemble_gaps', 'pareto_models', 'bo_trial_13',
                       'model.pth')


@pytest.fixture(scope='module')
def jax_model():
    return jax_ensemble(descr(in_dim=5, width=32, hidden=2), members=3)


@pytest.fixture(scope='module')
def predictor(jax_model, tmp_path_factory):
    path = str(tmp_path_factory.mktemp('bundle') / 'model.pth')
    jax_save_model(jax_model, path)
    return Predictor(path, device='cpu')


@pytest.mark.parametrize('rows', [1, 300, 1025])
def test_predictor_matches_jax_model(jax_model, predictor, rows):
    """1, 300 and 1,025 rows cross bucket boundaries (256, 1024, 4096) and
    pad with the first row."""
    x = np.random.default_rng(rows).normal(size=(rows, 5)).astype(np.float32)
    mean, std = predictor.predict(x)
    assert mean.shape == std.shape == (rows, 1)
    assert_ue_close((mean, std), jax_model(x, return_ue=True))


def test_predictor_chunks_requests_beyond_the_largest_bucket(jax_model):
    pred = Predictor(port_of(jax_model), buckets=(32, 64), device='cpu',
                     warmup=False)
    x = np.random.default_rng(5).normal(size=(150, 5)).astype(np.float32)
    got = pred.predict(x)
    assert got[0].shape == (150, 1)
    assert_ue_close(got, jax_model(x, return_ue=True))


def test_predictor_single_row_and_float64(jax_model, predictor):
    x = np.random.default_rng(6).normal(size=5)          # float64, 1-D
    mean, std = predictor.predict(x)
    assert mean.shape == std.shape == (1,)
    ref = jax_model(x.astype(np.float32)[None], return_ue=True)
    assert_ue_close((mean, std), tuple(np.asarray(r)[0] for r in ref))
    assert predictor.num_features == 5
    assert predictor.buckets == DEFAULT_BUCKETS


def test_model_call_chunks_above_the_largest_bucket(jax_model, monkeypatch):
    pm = port_of(jax_model)
    x = np.random.default_rng(7).normal(size=(700, 5)).astype(np.float32)
    whole = pm(x, return_ue=True)
    monkeypatch.setattr(base, '_MAX_BUCKET', 256)
    chunked = pm(x, return_ue=True)
    for a, b in zip(whole, chunked):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL_MEAN)
    assert_ue_close(chunked, jax_model(x, return_ue=True))


def test_port_bundle_loads_in_jax(jax_model, tmp_path):
    path = str(tmp_path / 'model.pth')
    save_model(port_of(jax_model), path)
    back = jax_load_model(path)
    x = np.random.default_rng(8).normal(size=(64, 5)).astype(np.float32)
    assert_ue_close(back(x, return_ue=True), jax_model(x, return_ue=True))


def test_trained_bundle_matches_jax():
    """A JAX-trained bundle (8 members, 8 inputs, 7 x 128) read by both
    packages gives the same answers on 512 rows."""
    jm = jax_load_model(TRAINED)
    pm = load_model(TRAINED, device='cpu')
    assert pm.num_models == 8 and pm.net.layers[0].weight.shape == (8, 128, 8)
    x = np.random.default_rng(9).normal(size=(512, 8)).astype(np.float32)
    ref = jm(x, return_ue=True)
    assert_ue_close(pm(x, return_ue=True), ref)
    pred = Predictor(pm, buckets=(128, 256), device='cpu', warmup=False)
    assert_ue_close(pred.predict(x), ref)


def test_mlp_bundle_matches_jax(tmp_path):
    jm = JaxMLPModelBuilder(descr(in_dim=4, width=16, hidden=1, out_dim=2),
                            train_config={'loss': 'l1_loss'}).build()
    path = str(tmp_path / 'model.pth')
    jax_save_model(jm, path)
    pm = load_model(path, device='cpu')
    x = np.random.default_rng(10).normal(size=(20, 4)).astype(np.float32)
    np.testing.assert_allclose(pm(x).numpy(), np.asarray(jm(x)), **TOL_MEAN)
    with pytest.raises(NotImplementedError):
        pm(x, return_ue=True)


def test_unported_model_class_is_named(jax_model, tmp_path):
    # every class of the JAX package is ported; a bundle naming any other
    # class still raises with its name
    config = dict(jax_model.config_dict(), **{'class': 'EvidentialMLPModel'})
    path = str(tmp_path / 'model.pth')
    with open(path, 'wb') as f:
        pickle.dump({'format': 'nnueehcs_tpu-ckpt-v1', 'config': config,
                     'arrays': jax_model.arrays_dict()}, f)
    with pytest.raises(NotImplementedError, match='EvidentialMLPModel'):
        load_model(path, device='cpu')


def test_bundle_loader_refuses_foreign_globals(tmp_path):
    path = str(tmp_path / 'model.pth')
    with open(path, 'wb') as f:
        pickle.dump({'format': 'nnueehcs_tpu-ckpt-v1', 'x': os.getcwd}, f)
    with pytest.raises(pickle.UnpicklingError, match='unexpected global'):
        load_model(path, device='cpu')


def test_bf16_precision_is_not_ported(jax_model):
    """Once a refusal, now the other way round: a bundle whose
    train_config names bf16-mixed loads into a bf16 model and serves in
    bf16 (fp32 answers, away from the fp32 ones)."""
    config = dict(jax_model.config_dict())
    config['train_config'] = dict(config['train_config'], precision='bf16-mixed')
    from nnueehcs_tpu_torch.training import build_from_bundle
    m = build_from_bundle({'format': 'nnueehcs_tpu-ckpt-v1', 'config': config,
                           'arrays': jax_model.arrays_dict()}, device='cpu')
    assert m.precision == 'bf16-mixed'
    assert m.net.compute_dtype == torch.bfloat16
    assert m.fused_weights().w_all.dtype == torch.bfloat16
    x = np.random.default_rng(3).normal(size=(300, 5)).astype(np.float32)
    mean, std = Predictor(m, device='cpu').predict(x)
    assert mean.dtype == std.dtype == np.float32
    ref = port_of(jax_model)(x, return_ue=True)
    assert float(np.abs(mean - ref[0].numpy()).max()) > 1e-5


def test_ensemble_rejects_a_network_of_other_width():
    from nnueehcs_tpu_torch.models import EnsembleModel
    from nnueehcs_tpu_torch.nn.network import build_network
    with pytest.raises(ValueError, match='num_models'):
        EnsembleModel(build_network(descr(), members=2), num_models=3)
