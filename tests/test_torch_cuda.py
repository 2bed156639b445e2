"""The port's CUDA kernels on a card (the fused ensemble, MC-dropout,
anchored, KDE and training kernels, and the attribution probes of the
ensemble and training kernels), each held against its plain PyTorch
version on the same inputs, and the serving path of each model on the card. Every test here is
marked ``cuda`` and skips without a card. The file imports neither JAX nor
the JAX package, so it runs on a CUDA-only machine (with ``--noconftest``,
since tests/conftest.py imports JAX):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: mean 1e-5 absolute and relative; std 1e-3 relative, 1e-5
absolute (fp32 sums taken in another order than cuBLAS takes them). The
MC-dropout kernel and its plain version draw the same hash masks for the
same seed, so they are compared with the same tolerances. The bf16 forms
(kernels 1, 2 and 5 and the packed probe) are held to their plain versions
against the bf16-vs-fp32 gap on the same rows (``attrib.bf16_close``: the
error's root mean square within 0.2 of the gap's, its max within the gap's
max; the two sum in another order, so a few bf16 roundings go the other
way).
KDE log density:
1e-4 absolute plus 1e-5 relative (float32 round-off in the distance
decomposition, scaled by gamma; tests/test_torch_kde.py). Training kernel
against its plain epoch, absolute (``chip_smoke.TOL_TRAIN``): losses
5e-6, Adam moments 1e-6, parameters and BatchNorm running statistics 1e-5
(as tests/test_torch_fused_train.py holds the plain epoch to the JAX
kernel; the dropout masks are the same hash in both), over whole epochs on
networks whose pre-ReLU values are kept away from 0
(``chip_smoke.separate_relu``), and step by step on the flagship as built,
where a value beyond tolerance must lie in the reach of a ReLU decision
the two took differently (``chip_smoke.stepwise_vs_plain``)."""
import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (FLAGSHIP, TOL_TRAIN, separate_relu,
                        stepwise_vs_plain, train_inputs, train_plan)
from nnueehcs_tpu_torch.attrib import BINDING_CLIP, TOL_NORM, bf16_close
from nnueehcs_tpu_torch.convert import tensor_trees
from nnueehcs_tpu_torch.model_builder import (DeltaUQMLPModelBuilder,
                                              EnsembleModelBuilder,
                                              KDEModelBuilder,
                                              MCDropoutModelBuilder,
                                              MVEModelBuilder,
                                              PAGERModelBuilder)
from nnueehcs_tpu_torch.ops import ablate_epoch as ae
from nnueehcs_tpu_torch.ops import ablate_forward as af
from nnueehcs_tpu_torch.ops import fused_anchored as fa
from nnueehcs_tpu_torch.ops import fused_mc_dropout as mc
from nnueehcs_tpu_torch.ops.fused_anchored import (anchor_rows,
                                                   fused_anchored_plain,
                                                   fused_anchored_stats)
from nnueehcs_tpu_torch.ops.fused_ensemble import (fused_forward_plain,
                                                   fused_forward_prefolded,
                                                   prepare_fused_weights)
from nnueehcs_tpu_torch.ops.fused_mc_dropout import (fused_mc_forward,
                                                     fused_mc_forward_plain)
from nnueehcs_tpu_torch.ops.kde import (bandwidth_value, centre, kde_logpdf,
                                        kde_logpdf_plain)
from nnueehcs_tpu_torch.ops import fused_train as ft
from nnueehcs_tpu_torch.serving import Predictor
from nnueehcs_tpu_torch.training import (ArrayDataset, DataLoader, Trainer,
                                         load_model, save_model)

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


def _both(model, prepare):
    """``prepare(model.net)`` in bf16 and in fp32; the model is left in
    bf16."""
    model.set_precision('32-true')
    w32 = prepare(model.net)
    model.set_precision('bf16-mixed')
    return prepare(model.net), w32


def _bf16_pair(name, got, want, fp32):
    """Each of the (mean, std) pair within the bf16 bar of its plain
    version (attrib.bf16_close)."""
    for i, (g, w, f) in enumerate(zip(got, want, fp32)):
        bf16_close(f'{name} out{i}', g, w, f)


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(CASES))
def test_bf16_kernel_matches_plain_on_card(card, case):
    """Kernel 1's bf16 form against its plain version, and an x that is not
    fp32 refused on the card as on the CPU."""
    members, in_dim, width, hidden, out_dim, rows = CASES[case]
    fw, fw32 = _both(_model(card, members, in_dim, width, hidden, out_dim),
                     prepare_fused_weights)
    assert fw.w_all.dtype == torch.bfloat16
    x = torch.as_tensor(np.random.default_rng(6).normal(size=(rows, in_dim)),
                        dtype=torch.float32, device=card)
    before = (fused_forward_prefolded.launches,
              fused_forward_prefolded.launches_bf16)
    got = fused_forward_prefolded(fw, x)
    torch.cuda.synchronize()
    assert (fused_forward_prefolded.launches,
            fused_forward_prefolded.launches_bf16) == (before[0],
                                                       before[1] + 1)
    _bf16_pair(case, got, fused_forward_plain(fw, x),
               fused_forward_plain(fw32, x))
    with pytest.raises(TypeError):
        fused_forward_prefolded(fw, x.bfloat16())


MC_CASES = {
    # name: (in_dim, width, hidden, out_dim, p, samples, rows)
    'flagship': (5, 128, 6, 1, 0.1, 128, 65_536),
    'ragged': (5, 128, 6, 1, 0.1, 128, 1000),
    'p0': (5, 128, 6, 1, 0.0, 16, 1000),
    'p_half_wide_out': (40, 32, 3, 3, 0.5, 7, 777),
    'wide_input': (200, 128, 2, 1, 0.2, 9, 300),
    'one_sample': (5, 64, 2, 2, 0.3, 1, 129),
}

ANCHORED_CASES = {
    # name: (in_dim, width, hidden, out_dim, anchors, rows)
    'flagship': (5, 128, 6, 1, 229, 65_536),
    'ragged': (5, 128, 6, 1, 229, 1000),
    'two_linears': (7, 64, 1, 2, 5, 300),
    'wide_input': (100, 128, 2, 1, 17, 129),
    'two_anchors': (5, 32, 2, 1, 2, 70),
}


def _randomize_bn(m):
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for layer in m.net.layers:
            if hasattr(layer, 'running_var'):
                shape = layer.running_var.shape
                layer.running_mean.copy_(torch.randn(shape, generator=gen) * 0.3)
                layer.running_var.copy_(torch.rand(shape, generator=gen) + 0.5)
    return m


def _mc_model(card, in_dim, width, hidden, out_dim, p, samples):
    return _randomize_bn(MCDropoutModelBuilder(
        _arch(in_dim, width, hidden, out_dim),
        {'num_samples': samples, 'dropout_percent': p}, seed=5,
        device=card).build())


def _anchored_model(card, builder, in_dim, width, hidden, out_dim, anchors):
    m = _randomize_bn(builder(_arch(in_dim, width, hidden, out_dim),
                              {'num_anchors': anchors}, seed=5,
                              device=card).build())
    rng = np.random.default_rng(9)
    m.anchors = rng.normal(size=(anchors, in_dim))
    if hasattr(m, 'anchors_Y'):
        m.anchors_Y = rng.normal(size=(anchors, 1))
    return m


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(MC_CASES))
def test_mc_kernel_matches_plain_on_card(card, case):
    in_dim, width, hidden, out_dim, p, samples, rows = MC_CASES[case]
    mw = _mc_model(card, in_dim, width, hidden, out_dim, p, samples).mc_weights()
    assert mw is not None
    x = torch.as_tensor(np.random.default_rng(6).normal(size=(rows, in_dim)),
                        dtype=torch.float32, device=card)
    before = fused_mc_forward.launches
    mean, std = fused_mc_forward(mw, x, samples, 1234567)
    torch.cuda.synchronize()
    assert fused_mc_forward.launches == before + 1
    ref_mean, ref_std = fused_mc_forward_plain(mw, x, samples, 1234567)
    torch.testing.assert_close(mean, ref_mean, **TOL_MEAN)
    torch.testing.assert_close(std, ref_std, **TOL_STD)
    if p == 0.0:
        assert float(std.abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(ANCHORED_CASES))
def test_anchored_kernel_matches_plain_on_card(card, case):
    in_dim, width, hidden, out_dim, anchors, rows = ANCHORED_CASES[case]
    m = _anchored_model(card, DeltaUQMLPModelBuilder, in_dim, width, hidden,
                        out_dim, anchors)
    aw = m.anchored_weights()
    assert aw is not None
    x = torch.as_tensor(np.random.default_rng(6).normal(size=(rows, in_dim)),
                        dtype=torch.float32, device=card)
    before = fused_anchored_stats.launches
    mean, std = fused_anchored_stats(aw, x, m.anchors)
    torch.cuda.synchronize()
    assert fused_anchored_stats.launches == before + 1
    ref_mean, ref_std = fused_anchored_plain(aw, x, anchor_rows(aw, m.anchors))
    torch.testing.assert_close(mean, ref_mean, **TOL_MEAN)
    torch.testing.assert_close(std, ref_std, **TOL_STD)


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(MC_CASES))
def test_bf16_mc_kernel_matches_plain_on_card(card, case):
    in_dim, width, hidden, out_dim, p, samples, rows = MC_CASES[case]
    mw, mw32 = _both(_mc_model(card, in_dim, width, hidden, out_dim, p,
                               samples), lambda net: mc.prepare_mc_weights(net))
    x = torch.as_tensor(np.random.default_rng(6).normal(size=(rows, in_dim)),
                        dtype=torch.float32, device=card)
    before = (fused_mc_forward.launches, fused_mc_forward.launches_bf16)
    got = fused_mc_forward(mw, x, samples, 1234567)
    torch.cuda.synchronize()
    assert (fused_mc_forward.launches,
            fused_mc_forward.launches_bf16) == (before[0], before[1] + 1)
    _bf16_pair(case, got, fused_mc_forward_plain(mw, x, samples, 1234567),
               fused_mc_forward_plain(mw32, x, samples, 1234567))
    if p == 0.0:
        assert float(got[1].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(ANCHORED_CASES))
def test_bf16_anchored_kernel_matches_plain_on_card(card, case):
    in_dim, width, hidden, out_dim, anchors, rows = ANCHORED_CASES[case]
    m = _anchored_model(card, DeltaUQMLPModelBuilder, in_dim, width, hidden,
                        out_dim, anchors)
    aw, aw32 = _both(m, lambda net: fa.prepare_fused_anchored(net))
    x = torch.as_tensor(np.random.default_rng(6).normal(size=(rows, in_dim)),
                        dtype=torch.float32, device=card)
    before = (fused_anchored_stats.launches,
              fused_anchored_stats.launches_bf16)
    got = fused_anchored_stats(aw, x, m.anchors)
    torch.cuda.synchronize()
    assert (fused_anchored_stats.launches,
            fused_anchored_stats.launches_bf16) == (before[0], before[1] + 1)
    _bf16_pair(case, got, fused_anchored_plain(aw, x, anchor_rows(aw, m.anchors)),
               fused_anchored_plain(aw32, x, anchor_rows(aw32, m.anchors)))


@pytest.mark.cuda
@pytest.mark.parametrize('builder', [EnsembleModelBuilder,
                                     MCDropoutModelBuilder,
                                     DeltaUQMLPModelBuilder])
def test_predictor_on_card_runs_the_bf16_kernels(card, builder):
    """A model switched to bf16-mixed serves through its kernel's bf16 form
    (fp32 answers), and back in fp32 through the fp32 form, bit for bit as
    before the switch."""
    if builder is EnsembleModelBuilder:
        m, fn = _model(card, 8, 5, 128, 6, 1), fused_forward_prefolded
    elif builder is MCDropoutModelBuilder:
        m, fn = _mc_model(card, 5, 128, 6, 1, 0.1, 32), fused_mc_forward
    else:
        m, fn = _anchored_model(card, builder, 5, 128, 6, 1, 23), \
            fused_anchored_stats
    x = np.random.default_rng(7).normal(size=(3000, 5)).astype(np.float32)
    pred = Predictor(m, device=card, warmup=False)
    if builder is MCDropoutModelBuilder:
        m.reseed(0)
    first = pred.predict(x)
    m.set_precision('bf16-mixed')
    if builder is MCDropoutModelBuilder:
        m.reseed(0)
    before = (fn.launches, fn.launches_bf16)
    got = pred.predict(x)
    assert (fn.launches, fn.launches_bf16) == (before[0], before[1] + 1)
    assert all(g.dtype == np.float32 for g in got)
    assert any(float(np.abs(g - f).max()) > 0 for g, f in zip(got, first))
    m.set_precision('32-true')
    if builder is MCDropoutModelBuilder:
        m.reseed(0)
    again = pred.predict(x)
    for a, f in zip(again, first):
        assert np.array_equal(a, f)


@pytest.mark.cuda
def test_predictor_on_card_runs_the_mc_kernel(card):
    m = _mc_model(card, 5, 128, 6, 1, 0.1, 32)
    x = np.random.default_rng(7).normal(size=(5000, 5)).astype(np.float32)
    pred = Predictor(m, device=card, warmup=False)
    before = fused_mc_forward.launches
    mean, std = pred.predict(x)
    assert fused_mc_forward.launches == before + 1          # one 16384 bucket
    want = fused_mc_forward_plain(m.mc_weights(), torch.from_numpy(x).to(card),
                                  32, m.call_seed(0))
    torch.testing.assert_close(torch.from_numpy(mean), want[0].cpu(), **TOL_MEAN)
    torch.testing.assert_close(torch.from_numpy(std), want[1].cpu(), **TOL_STD)


@pytest.mark.cuda
@pytest.mark.parametrize('builder', [DeltaUQMLPModelBuilder, PAGERModelBuilder])
def test_predictor_on_card_runs_the_anchored_kernel(card, builder):
    m = _anchored_model(card, builder, 5, 128, 6, 1, 23)
    x = np.random.default_rng(8).normal(size=(3000, 5)).astype(np.float32)
    pred = Predictor(m, device=card, warmup=False)
    before = fused_anchored_stats.launches
    mean, ue = pred.predict(x)
    assert fused_anchored_stats.launches == before + 1      # one 4096 bucket
    xt = torch.from_numpy(x).to(card)
    with torch.no_grad():
        ref_mean, ref_ue = m.anchored_stats_modules(xt, m.anchors, 23)
        if builder is PAGERModelBuilder:
            p = m.prediction_matrix(xt, m.anchors)
            score = (p - m.anchors_Y.reshape(1, -1)).abs().amax(1, keepdim=True)
            ref_ue = torch.maximum(ref_ue, score)
    torch.testing.assert_close(torch.from_numpy(mean), ref_mean.cpu(), **TOL_MEAN)
    torch.testing.assert_close(torch.from_numpy(ue), ref_ue.cpu(), **TOL_STD)


KDE_CASES = {
    # name: (queries, references, d, offset, far): far puts the queries 50
    # bandwidths away from the corpus
    'bench_d5': (65_536, 16_384, 5, 0.0, False),
    'minibude_d6_ragged': (10_007, 45_824, 6, 0.0, False),
    'offset_1e3': (4096, 4096, 5, 1e3, False),
    'far_ood': (1000, 4096, 5, 0.0, True),
    'd37': (1000, 3001, 37, 0.0, False),
    'd1_one_reference': (333, 1, 1, 0.0, False),
    'd8': (777, 1025, 8, 0.0, False),
    'd9_one_query': (1, 300, 9, 0.0, False),
}
TOL_LOGPDF = {'rtol': 1e-5, 'atol': 1e-4}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(KDE_CASES))
def test_kde_kernel_matches_plain_on_card(card, case):
    b, n, d, offset, far = KDE_CASES[case]
    rng = np.random.default_rng(11)
    data = rng.normal(size=(n, d)) + offset
    h = bandwidth_value('silverman', n, d)
    x = rng.normal(size=(b, d)) + offset
    if far:
        x[:, 0] += 2 * np.abs(data).max() + 50 * h
    x, data = (torch.as_tensor(a, dtype=torch.float32, device=card)
               for a in (x, data))
    before = kde_logpdf.launches
    got = kde_logpdf(x, data, h)
    torch.cuda.synchronize()
    assert kde_logpdf.launches == before + 1
    want = kde_logpdf_plain(*centre(x, data), h)
    assert got.shape == (b,) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, **TOL_LOGPDF)
    if far:
        assert float(torch.exp(got).max()) == 0.0


@pytest.mark.cuda
def test_predictor_on_card_runs_the_kde_kernel(card):
    m = _randomize_bn(KDEModelBuilder(_arch(5, 128, 6, 1), {'rtol': 1000},
                                      seed=5, device=card).build())
    rng = np.random.default_rng(12)
    m.fit_kde(rng.normal(size=(16_384, 5)).astype(np.float32))
    assert m.kde.data.device.type == 'cuda'
    x = rng.normal(size=(5000, 5)).astype(np.float32)
    pred = Predictor(m, device=card, warmup=False)
    before = kde_logpdf.launches
    mean, ue = pred.predict(x)
    assert kde_logpdf.launches == before + 1                # one 16384 bucket
    xt = torch.from_numpy(x).to(card)
    with torch.no_grad():
        ref_mean = m.net(xt)
    ref_ue = -torch.exp(kde_logpdf_plain(*centre(xt, m.kde.data),
                                         m.kde.bandwidth_))
    assert ue.shape == (5000,)
    torch.testing.assert_close(torch.from_numpy(mean), ref_mean.cpu(),
                               **TOL_MEAN)
    torch.testing.assert_close(torch.from_numpy(ue), ref_ue.cpu(),
                               rtol=1e-4, atol=1e-30)


@pytest.mark.cuda
def test_kde_kernel_refuses_non_f32_on_card(card):
    data = torch.zeros(10, 5, device=card)
    for dtype in (torch.float64, torch.bfloat16, torch.float16):
        with pytest.raises(TypeError):
            kde_logpdf(torch.zeros(4, 5, dtype=dtype, device=card), data, 0.5)


TRAIN_CASES = {
    # name: (family, width, hidden, members, batch, loss, per_member,
    #        weight decay, dropout rate)
    'small_joint_l1': ('ensemble', 32, 2, 3, 16, 'l1_loss', False, 0.0, 0.0),
    'small_per_member_mse_wd': ('ensemble', 32, 2, 3, 16, 'mse_loss', True,
                                0.01, 0.0),
    'small_mve': ('mve', 32, 2, 1, 16, 'gaussian_nll', False, 0.0, 0.0),
    'small_mc_p02': ('mc', 32, 3, 1, 16, 'l1_loss', False, 0.0, 0.2),
    'small_mc_p1': ('mc', 32, 3, 1, 16, 'l1_loss', False, 0.0, 1.0),
    'batch_256': ('ensemble', 64, 2, 2, 256, 'l1_loss', False, 0.0, 0.0),
    'batch_40': ('ensemble', 24, 3, 2, 40, 'mse_loss', False, 0.0, 0.0),
    'flagship_joint_l1': ('ensemble', 128, 6, 8, 128, 'l1_loss', False, 0.0,
                          0.0),
    'flagship_per_member_mse_wd': ('ensemble', 128, 6, 8, 128, 'mse_loss',
                                   True, 0.01, 0.0),
    'flagship_mve': ('mve', 128, 6, 1, 128, 'gaussian_nll', False, 0.0, 0.0),
    'flagship_mc_p01': ('mc', 128, 6, 1, 128, 'l1_loss', False, 0.0, 0.1),
}


def _train_model(card, family, width, hidden, members, p):
    arch = _arch(5, width, hidden, 1)
    if family == 'ensemble':
        m = EnsembleModelBuilder(arch, {'num_models': members}, seed=5,
                                 device=card).build()
    elif family == 'mve':
        m = MVEModelBuilder(arch, {}, seed=5, device=card).build()
    else:
        m = MCDropoutModelBuilder(arch, {'num_samples': 4,
                                         'dropout_percent': p},
                                  seed=5, device=card).build()
    return _randomize_bn(m)


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(TRAIN_CASES))
def test_training_kernel_matches_plain_on_card(card, case):
    family, width, hidden, members, batch, loss, per_member, wd, p = \
        TRAIN_CASES[case]
    m = separate_relu(_train_model(card, family, width, hidden, members, p),
                      torch.Generator().manual_seed(11))
    plan = ft.plan_fused_train(m.net, members, batch, loss=loss,
                               per_member=per_member, clip=5.0,
                               weight_decay=wd,
                               member_stacked=family == 'ensemble')
    assert plan is not None
    params, state = tensor_trees(m.net)
    gen = torch.Generator().manual_seed(8)

    def moments(scale, positive=False):
        tree = [{k: torch.randn(v.shape, generator=gen) * scale
                 for k, v in layer.items()} for layer in params]
        if positive:
            tree = [{k: v.abs() for k, v in layer.items()} for layer in tree]
        return ft.pack_tree(plan, tree, card)
    bufs = [ft.pack_tree(plan, params, card), moments(1e-3),
            moments(1e-6, positive=True), ft.pack_state(plan, state, card)]
    rng = np.random.default_rng(9)
    steps = 6
    x = torch.as_tensor(rng.normal(size=(steps * batch, 5)),
                        dtype=torch.float32, device=card)
    y = torch.sin(x).sum(1, keepdim=True)
    xs, ys = ft.gather_epoch_batches(plan, x, y,
                                     torch.arange(steps * batch, device=card))
    drops = ft.drop_rates(m.net).to(card)
    before = ft.fused_epoch.launches
    got = ft.fused_epoch(plan, *[b.clone() for b in bufs], xs, ys, 1e-3, 7,
                         seed=424242, drops=drops)
    torch.cuda.synchronize()
    assert ft.fused_epoch.launches == before + 1
    want = ft.fused_epoch_reference(plan, *[b.clone() for b in bufs], xs, ys,
                                    1e-3, 7, seed=424242, drops=drops)
    for (name, tol), a, b in zip(TOL_TRAIN.items(), got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=tol, msg=name)
    assert bool(torch.isfinite(got[4]).all())


@pytest.mark.cuda
def test_training_kernel_misses_follow_relu_flips_on_card(card):
    """The flagship ensemble as built (BatchNorm scale 1, shift 0), 16
    steps, each from the plain version's state: every value beyond
    tolerance lies in the reach of a ReLU decision recorded differently by
    the kernel and the plain version."""
    m = EnsembleModelBuilder(FLAGSHIP, {'num_models': 8}, seed=3,
                             device=card).build()
    plan = train_plan(m)
    bufs, xs, ys = train_inputs(m, plan, np.random.default_rng(12), 16)
    before = ft.fused_epoch.launches
    out = stepwise_vs_plain(plan, bufs, xs, ys, 1e-3, 5, 99,
                            ft.drop_rates(m.net).to(card))
    assert ft.fused_epoch.launches == before + 16
    assert out['over_tol_outside_reach'] == 0


@pytest.mark.cuda
@pytest.mark.parametrize('family', ['ensemble', 'mc', 'mve', 'kde'])
def test_trainer_on_card_runs_the_training_kernel(card, family, tmp_path):
    """Every epoch the JAX trainer would run through its kernel runs
    through this one; KDE's epoch 0 runs step by step on the card (its
    fit hook reads the batches), then hands over to the kernel."""
    if family == 'kde':
        m = _randomize_bn(KDEModelBuilder(_arch(5, 32, 2, 1), {'rtol': 1000},
                                          seed=5, device=card).build())
    else:
        m = _train_model(card, family, 32, 2, 3, 0.2)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(512, 5)).astype(np.float32)
    y = np.sin(x).sum(1, keepdims=True).astype(np.float32)
    tr = Trainer('t', {'max_epochs': 3, 'gradient_clip_val': 5.0},
                 callbacks=m.get_callbacks(), log_dir=str(tmp_path),
                 device=card)
    before = ft.fused_epoch.launches
    tr.fit(m, DataLoader(ArrayDataset(x, y), 64, shuffle=True,
                         drop_last=True))
    kernel_epochs = 2 if family == 'kde' else 3
    assert tr.fused_epochs_used == kernel_epochs
    assert ft.fused_epoch.launches == before + kernel_epochs
    if family == 'kde':
        assert m.kde.data.device.type == 'cuda' and len(m.kde.data) == 512
    assert np.isfinite(tr.callback_metrics['val_loss'])
    if family == 'ensemble':
        # the trainer's write-back reaches the folded serving weights
        path = str(tmp_path / 'after.pth')
        save_model(m, path)
        fresh = load_model(path, device=card)
        for a, b in zip(m(x, return_ue=True), fresh(x, return_ue=True)):
            torch.testing.assert_close(a, b, **TOL_MEAN)


# the attribution probes of kernels 1 and 3 (ops/ablate_forward.py,
# ops/ablate_epoch.py): every mode against its plain version, and each
# prod form against the production kernel, bit for bit
ABLATE_CASES = {
    # name: (members, in_dim, width, hidden, out_dim, rows)
    'flagship': (8, 5, 128, 6, 1, 65_536),
    'ragged': (8, 5, 128, 6, 1, 1000),
    'narrow_out3': (3, 7, 32, 2, 3, 777),
    'single_linear': (2, 9, 9, 0, 4, 129),
}


def _padded(x, width):
    return torch.nn.functional.pad(x, (0, width - x.shape[1])).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(ABLATE_CASES))
@pytest.mark.parametrize('mode', af.MODES)
@pytest.mark.parametrize('n_out', [1, 2])
def test_ablate_forward_matches_plain_on_card(card, case, mode, n_out):
    members, in_dim, width, hidden, out_dim, rows = ABLATE_CASES[case]
    fw = prepare_fused_weights(_model(card, members, in_dim, width, hidden,
                                      out_dim).net)
    x = torch.as_tensor(np.random.default_rng(6).normal(size=(rows, in_dim)),
                        dtype=torch.float32, device=card)
    x_pad = _padded(x, 128)
    cuts = [(None, None), (1, None), (None, 1), (2, 2)]
    for members_cut, layers_cut in cuts:
        if layers_cut is not None and layers_cut > fw.num_layers:
            continue
        before = af.ablate_forward.launches
        got = af.ablate_forward(fw, x_pad, members_cut, layers_cut, 64, mode,
                                n_out)
        torch.cuda.synchronize()
        assert af.ablate_forward.launches == before + 1
        want = af.ablate_forward_plain(fw, x_pad, members_cut, layers_cut, 64,
                                       mode, n_out)
        if mode == 'io_floor':
            for g, w in zip(got, want):
                assert torch.equal(g, w)
            continue
        torch.testing.assert_close(got[0], want[0], **TOL_MEAN)
        if n_out == 2:
            tol = TOL_MEAN if mode == 'no_epi' else TOL_STD
            torch.testing.assert_close(got[1], want[1], **tol)


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(ABLATE_CASES))
def test_packed_bf16_matches_plain_and_kernel_1_on_card(card, case):
    """The packed probe's bf16 form against its plain version and, bit for
    bit, against kernel 1's bf16 form; the other probes refuse bf16
    weights."""
    members, in_dim, width, hidden, out_dim, rows = ABLATE_CASES[case]
    fw, fw32 = _both(_model(card, members, in_dim, width, hidden, out_dim),
                     prepare_fused_weights)
    x = torch.as_tensor(np.random.default_rng(7).normal(size=(rows, in_dim)),
                        dtype=torch.float32, device=card)
    x_pad = _padded(x, 128)
    before = (af.packed_forward.launches, af.packed_forward.launches_bf16)
    got = af.packed_forward(fw, x_pad)
    torch.cuda.synchronize()
    assert (af.packed_forward.launches,
            af.packed_forward.launches_bf16) == (before[0], before[1] + 1)
    _bf16_pair(case, got, af.packed_forward_plain(fw, x_pad),
               af.packed_forward_plain(fw32, x_pad))
    mean, std = fused_forward_prefolded(fw, x)
    assert torch.equal(got[0], mean) and torch.equal(got[1], std)
    with pytest.raises(ValueError, match='float32'):
        af.ablate_forward(fw, x_pad)


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(ABLATE_CASES))
def test_layout_probes_match_plain_and_production_on_card(card, case):
    members, in_dim, width, hidden, out_dim, rows = ABLATE_CASES[case]
    fw = prepare_fused_weights(_model(card, members, in_dim, width, hidden,
                                      out_dim).net)
    x = torch.as_tensor(np.random.default_rng(7).normal(size=(rows, in_dim)),
                        dtype=torch.float32, device=card)
    mean, std = fused_forward_prefolded(fw, x)
    feat = max(8, in_dim)
    calls = [(af.ablate_forward, af.ablate_forward_plain, (_padded(x, 128),)),
             (af.xt_forward, af.xt_forward_plain,
              (_padded(x, feat).T.contiguous(),)),
             (af.xt_forward, af.xt_forward_plain,
              (_padded(x, feat).T.contiguous(), True, 8))]
    if in_dim <= 8:
        calls += [(af.narrow_forward, af.narrow_forward_plain,
                   (_padded(x, 8), True, out_dim <= 8)),
                  (af.narrow_forward, af.narrow_forward_plain,
                   (_padded(x, 128), False, True))]
    calls += [(af.narrow_forward, af.narrow_forward_plain,
               (_padded(x, 128), False, False)),
              (af.packed_forward, af.packed_forward_plain,
               (_padded(x, 128),))]
    for fn, plain, args in calls:
        before = fn.launches
        got = fn(fw, *args)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        want = plain(fw, *args)
        torch.testing.assert_close(got[0], want[0], **TOL_MEAN)
        torch.testing.assert_close(got[1], want[1], **TOL_STD)
        if got[0].shape[0] == rows:          # kernel 1's math, bit for bit
            n = min(out_dim, got[0].shape[1])
            assert torch.equal(got[0][:, :n], mean[:, :n])
            assert torch.equal(got[1][:, :n], std[:, :n])
        else:                                # feature-major
            assert torch.equal(got[0][:out_dim].T, mean)
            assert torch.equal(got[1][:out_dim].T, std)


ABLATE_TRAIN_VARIANTS = [
    dict(mode=mode) for mode in ae.MODES] + [
    dict(unroll=2), dict(unroll=4, mode='no_opt'), dict(gn_fused=True),
    dict(opt_chunk=8), dict(opt_chunk=1), dict(unroll=4, gn_fused=True,
                                               opt_chunk=32)]


@pytest.mark.cuda
@pytest.mark.parametrize('family,members', [('ensemble', 3), ('ensemble', 8),
                                            ('mc', 1)])
@pytest.mark.parametrize('variant', ABLATE_TRAIN_VARIANTS, ids=str)
def test_ablate_epoch_matches_plain_on_card(card, family, members, variant):
    width = 128 if members == 8 else 32
    m = separate_relu(_train_model(card, family, width, 6 if members == 8
                                   else 2, members, 0.2),
                      torch.Generator().manual_seed(13))
    plan = train_plan(m)
    bufs, xs, ys = train_inputs(m, plan, np.random.default_rng(14), 8)
    before = ae.ablate_epoch.launches
    got = ae.ablate_epoch(plan, *[b.clone() for b in bufs], xs, ys, 1e-3, 5,
                          **variant)
    torch.cuda.synchronize()
    assert ae.ablate_epoch.launches == before + 1
    want = ae.ablate_epoch_reference(plan, *[b.clone() for b in bufs], xs, ys,
                                     1e-3, 5, **variant)
    for (name, tol), a, b in zip(TOL_TRAIN.items(), got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=tol, msg=name)
    prod = ae.ablate_epoch(plan, *[b.clone() for b in bufs], xs, ys, 1e-3, 5,
                           mode=variant.get('mode', 'prod'))
    if not variant.get('gn_fused'):  # unroll and opt_chunk: the same sums
        for a, b in zip(got, prod):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize('variant', [
    dict(), dict(gn_fused=True), dict(unroll=4, gn_fused=True, opt_chunk=32),
    dict(mode='no_opt', gn_fused=True)], ids=str)
def test_ablate_epoch_grad_norms_with_a_binding_clip_on_card(card, variant):
    """With a clip below every step's gradient norm, the clip scale
    carries the members' sums of g^2 (gn_fused: taken as the backward
    writes g): each step's global norm agrees with the plain version's,
    the clip bound on every step, and the epochs agree."""
    m = separate_relu(_train_model(card, 'ensemble', 128, 6, 8, 0.2),
                      torch.Generator().manual_seed(13))
    plan = dataclasses.replace(train_plan(m), clip=BINDING_CLIP)
    bufs, xs, ys = train_inputs(m, plan, np.random.default_rng(14), 8)
    norms = [torch.empty(8, device=card) for _ in range(2)]
    got = ae.ablate_epoch(plan, *[b.clone() for b in bufs], xs, ys, 1e-3, 5,
                          norms=norms[0], **variant)
    want = ae.ablate_epoch_reference(plan, *[b.clone() for b in bufs], xs, ys,
                                     1e-3, 5, norms=norms[1], **variant)
    torch.testing.assert_close(norms[0], norms[1], **TOL_NORM)
    assert bool((torch.minimum(*norms) >= BINDING_CLIP).all())
    for (name, tol), a, b in zip(TOL_TRAIN.items(), got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=tol, msg=name)


@pytest.mark.cuda
def test_ablate_epoch_prod_is_kernel_3_bit_for_bit_on_card(card):
    m = EnsembleModelBuilder(FLAGSHIP, {'num_models': 8}, seed=3,
                             device=card).build()
    plan = train_plan(m)
    bufs, xs, ys = train_inputs(m, plan, np.random.default_rng(15), 40)
    got = ae.ablate_epoch(plan, *[b.clone() for b in bufs], xs, ys, 1e-3, 5)
    want = ft.fused_epoch(plan, *[b.clone() for b in bufs], xs, ys, 1e-3, 5)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# kernel 3's bf16 form (csrc/fused_train_bf16.cu) against its plain bf16
# epoch, step by step from the plain version's state
# (``attrib.stepwise_vs_plain_bf16``): m, the running statistics and each
# parameter's change in the step within the bf16 bars of the same step's
# plain bf16-vs-fp32 gap, v to Adam's update of the gradient m reveals, the
# per-step losses as one curve beside the host's plain epoch; whole epochs
# of the two part by whole bf16 units at a flipped rounding, so they are
# not compared
BF16_TRAIN_CASES = ('small_joint_l1', 'small_mc_p02', 'batch_40', 'batch_256',
                    'flagship_joint_l1', 'flagship_per_member_mse_wd',
                    'flagship_mve', 'flagship_mc_p01')


@pytest.mark.cuda
@pytest.mark.parametrize('case', BF16_TRAIN_CASES)
def test_training_kernel_bf16_matches_plain_stepwise_on_card(card, case):
    family, width, hidden, members, batch, loss, per_member, wd, p = \
        TRAIN_CASES[case]
    m = _train_model(card, family, width, hidden, members, p)
    plan = ft.plan_fused_train(m.net, members, batch, loss=loss,
                               per_member=per_member, clip=5.0,
                               weight_decay=wd, bf16=True,
                               member_stacked=family == 'ensemble')
    bufs, xs, ys = train_inputs(m, plan, np.random.default_rng(16), 6)
    before = (ft.fused_epoch.launches, ft.fused_epoch.launches_bf16)
    out = stepwise_vs_plain(plan, bufs, xs, ys, 1e-3, 5, 4242,
                            ft.drop_rates(m.net).to(card))
    assert (ft.fused_epoch.launches, ft.fused_epoch.launches_bf16) == \
        (before[0], before[1] + 6)
    assert out['steps'] == 6 and out['losses']['gap_max'] > 0


@pytest.mark.cuda
@pytest.mark.parametrize('bf16', [False, True])
def test_anchored_kernel_epoch_at_the_doubled_batch_on_card(card, bf16):
    """Δ-UQ's kernel epochs: the anchored gather on the card equals the
    CPU's, and the kernel at the doubled batch (2 x 128 rows of 10 anchored
    features) against its plain epoch: fp32 over a whole epoch on a network
    whose pre-ReLU values sit away from 0, bf16 step by step."""
    m = DeltaUQMLPModelBuilder(FLAGSHIP, {'num_anchors': 16}, seed=5,
                               device=card).build()
    if not bf16:
        separate_relu(m, torch.Generator().manual_seed(17))
    plan = ft.plan_fused_train(m.net, 1, 256, clip=5.0, bf16=bf16,
                               member_stacked=False)
    assert plan.in_pad == 16 and plan.batch == 256
    rng = np.random.default_rng(18)
    x = torch.as_tensor(rng.normal(size=(4 * 128, 5)), dtype=torch.float32)
    y = torch.sin(x).sum(1, keepdim=True)
    idx = torch.as_tensor(rng.permutation(4 * 128))
    perms = ft.anchor_permutations(torch.Generator().manual_seed(19), 4, 128)
    xs, ys = ft.gather_anchored_epoch_batches(plan, x.to(card), y.to(card),
                                              idx.to(card), perms.to(card))
    for a, b in zip((xs, ys), ft.gather_anchored_epoch_batches(
            plan, x, y, idx, perms)):
        assert torch.equal(a.cpu(), b)
    bufs, _, _ = train_inputs(m, plan, rng, 1)
    if bf16:
        out = stepwise_vs_plain(plan, bufs, xs, ys, 1e-3, 5, 0, None)
        assert out['steps'] == 4
        return
    got = ft.fused_epoch(plan, *[b.clone() for b in bufs], xs, ys, 1e-3, 5)
    want = ft.fused_epoch_reference(plan, *[b.clone() for b in bufs], xs, ys,
                                    1e-3, 5)
    for (name, tol), a, b in zip(TOL_TRAIN.items(), got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=tol, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize('family', ['ensemble', 'delta_uq', 'pager'])
@pytest.mark.parametrize('precision', ['32-true', 'bf16-mixed'])
def test_trainer_on_card_runs_the_training_kernel_form(card, family,
                                                       precision, tmp_path):
    """Each kernel epoch launches the form of the trainer's precision and
    no other: the ensemble's three epochs, Δ-UQ's and PAGER's after their
    per-step anchor epoch; the bf16 bundle reloads in bf16."""
    arch = _arch(5, 32, 2, 1)
    if family == 'ensemble':
        m = EnsembleModelBuilder(arch, {'num_models': 3}, seed=5,
                                 device=card).build()
    else:
        builder = DeltaUQMLPModelBuilder if family == 'delta_uq' \
            else PAGERModelBuilder
        m = builder(arch, {'num_anchors': 40}, seed=5, device=card).build()
    rng = np.random.default_rng(20)
    x = rng.normal(size=(512, 5)).astype(np.float32)
    y = np.sin(x).sum(1, keepdims=True).astype(np.float32)
    tr = Trainer('t', {'max_epochs': 3, 'gradient_clip_val': 5.0,
                       'precision': precision},
                 callbacks=m.get_callbacks(), log_dir=str(tmp_path),
                 device=card)
    before = (ft.fused_epoch.launches, ft.fused_epoch.launches_bf16)
    tr.fit(m, DataLoader(ArrayDataset(x, y), 64, shuffle=True,
                         drop_last=True))
    kernel_epochs = 3 if family == 'ensemble' else 2
    bf16 = precision == 'bf16-mixed'
    assert tr.fused_epochs_used == kernel_epochs
    assert (ft.fused_epoch.launches, ft.fused_epoch.launches_bf16) == (
        before[0] + (0 if bf16 else kernel_epochs),
        before[1] + (kernel_epochs if bf16 else 0))
    assert np.isfinite(tr.callback_metrics['val_loss'])
    if family != 'ensemble':
        assert m.anchors.shape == (40, 5) and m.anchors.device.type == 'cuda'
    path = str(tmp_path / 'after.pth')
    save_model(m, path)
    fresh = load_model(path, device=card)
    assert fresh.net.compute_dtype == (torch.bfloat16 if bf16 else None)
    for a, b in zip(m(x, return_ue=True), fresh(x, return_ue=True)):
        torch.testing.assert_close(a, b, **TOL_MEAN)
