"""The port's CUDA kernel on a card, held against its plain PyTorch version
on the same inputs, and the serving path on the card. Every test here is
marked ``cuda`` and skips without a card. The file imports neither JAX nor
the JAX package, so it runs on a CUDA-only machine (with ``--noconftest``,
since tests/conftest.py imports JAX):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: mean 1e-5 absolute and relative; std 1e-3 relative, 1e-5
absolute (fp32 sums taken in another order than cuBLAS takes them)."""
import numpy as np
import pytest
import torch

from nnueehcs_tpu_torch.model_builder import EnsembleModelBuilder
from nnueehcs_tpu_torch.ops.fused_ensemble import (fused_forward_plain,
                                                   fused_forward_prefolded,
                                                   prepare_fused_weights)
from nnueehcs_tpu_torch.serving import Predictor

TOL_MEAN = {'rtol': 1e-5, 'atol': 1e-5}
TOL_STD = {'rtol': 1e-3, 'atol': 1e-5}

CASES = {
    # name: (members, in_dim, width, hidden, out_dim, rows)
    'flagship': (8, 5, 128, 6, 1, 262_144),
    'ragged': (8, 5, 128, 6, 1, 1000),
    'narrow_wide_out': (3, 40, 32, 2, 3, 777),
    'wide_in_out': (2, 128, 128, 1, 128, 300),
    'single_member': (1, 7, 64, 1, 2, 129),
    'single_linear': (2, 9, 9, 0, 4, 65),
    'wide_input': (3, 200, 128, 2, 1, 1000),        # x staged in 32-col chunks
    'wide_input_single_linear': (2, 300, 8, 0, 4, 65),
    'deep': (2, 5, 16, 70, 1, 300),                 # 71 layers
}


def _arch(in_dim, width, hidden, out_dim):
    layers, fan_in = [], in_dim
    for _ in range(hidden):
        layers += [{'Linear': {'args': [fan_in, width]}},
                   {'BatchNorm1d': {'args': [width]}}, {'ReLU': {}}]
        fan_in = width
    return layers + [{'Linear': {'args': [fan_in, out_dim]}}]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _model(card, members, in_dim, width, hidden, out_dim):
    m = EnsembleModelBuilder(_arch(in_dim, width, hidden, out_dim),
                             {'num_models': members}, seed=5,
                             device=card).build()
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for layer in m.net.layers:
            if hasattr(layer, 'running_var'):
                shape = layer.running_var.shape
                layer.running_mean.copy_(torch.randn(shape, generator=gen) * 0.3)
                layer.running_var.copy_(torch.rand(shape, generator=gen) + 0.5)
    return m


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(CASES))
def test_fused_kernel_matches_plain_on_card(card, case):
    members, in_dim, width, hidden, out_dim, rows = CASES[case]
    fw = prepare_fused_weights(_model(card, members, in_dim, width, hidden,
                                      out_dim).net)
    x = torch.as_tensor(np.random.default_rng(6).normal(size=(rows, in_dim)),
                        dtype=torch.float32, device=card)
    before = fused_forward_prefolded.launches
    mean, std = fused_forward_prefolded(fw, x)
    torch.cuda.synchronize()
    assert fused_forward_prefolded.launches == before + 1
    ref_mean, ref_std = fused_forward_plain(fw, x)
    torch.testing.assert_close(mean, ref_mean, **TOL_MEAN)
    torch.testing.assert_close(std, ref_std, **TOL_STD)


@pytest.mark.cuda
def test_predictor_on_card_runs_the_kernel(card):
    m = _model(card, 8, 5, 128, 6, 1)
    x = np.random.default_rng(7).normal(size=(5000, 5)).astype(np.float32)
    pred = Predictor(m, device=card, warmup=False)
    before = fused_forward_prefolded.launches
    mean, std = pred.predict(x)
    assert fused_forward_prefolded.launches == before + 1   # one 16384 bucket
    with torch.no_grad():
        out = m.net(torch.from_numpy(x).to(card))           # unfused modules
    torch.testing.assert_close(torch.from_numpy(mean), out.mean(0).cpu(),
                               **TOL_MEAN)
    torch.testing.assert_close(torch.from_numpy(std),
                               out.std(0, correction=1).cpu(), **TOL_STD)


@pytest.mark.cuda
def test_wide_input_ensemble_runs_the_kernel_on_card(card):
    """A 200-input network, which the TPU kernel also runs fused, goes
    through the kernel on the card, not member by member."""
    m = _model(card, 4, 200, 128, 2, 1)
    x = np.random.default_rng(8).normal(size=(700, 200)).astype(np.float32)
    before = fused_forward_prefolded.launches
    mean, std = m(x, return_ue=True)
    assert fused_forward_prefolded.launches == before + 1
    with torch.no_grad():
        out = m.net(torch.from_numpy(x).to(card))           # unfused modules
    torch.testing.assert_close(mean, out.mean(0), **TOL_MEAN)
    torch.testing.assert_close(std, out.std(0, correction=1), **TOL_STD)


@pytest.mark.cuda
def test_kernel_refuses_bf16_on_card(card):
    fw = prepare_fused_weights(_model(card, 2, 5, 16, 1, 1).net)
    with pytest.raises(NotImplementedError):
        fused_forward_prefolded(fw, torch.zeros(4, 5, dtype=torch.bfloat16,
                                                device=card))
