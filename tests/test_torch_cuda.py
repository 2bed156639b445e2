"""The port's CUDA kernels on a card (the fused ensemble, MC-dropout,
anchored, KDE and training kernels, and the attribution probes of the
ensemble and training kernels), each held against its plain PyTorch
version on the same inputs, and the serving path of each model on the card.
Kernel 1b (one thread-block cluster of member blocks) runs 1 to 32
members, resident and through its ring, and twice on the same rows, bit
for bit; the KDE kernel runs every d of its tensor-core path. Every test here is
marked ``cuda`` and skips without a card. The file imports neither JAX nor
the JAX package, so it runs on a CUDA-only machine (with ``--noconftest``,
since tests/conftest.py imports JAX):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: mean 1e-5 absolute and relative; std 1e-3 relative, 1e-5
absolute (fp32 sums taken in another order than cuBLAS takes them; the
fp32 kernels' 3xTF32 products, and the MC-dropout and anchored kernels'
groups' sums merged by Chan's formula). The fp32 ensemble kernel runs 1
to 28 members (a cluster of min(M, 8) member blocks), a 12,800-row pass
against one launch a batch and twice, bit for bit. The
MC-dropout kernel and its plain version draw the same hash masks for the
same seed, so they are compared with the same tolerances. The fp32
MC-dropout and anchored kernels also run at the edges of their tiles,
groups (fewer samples or anchors than groups), inputs, outputs and depths,
twice on the same rows bit for bit, and compile without spills. The bf16 forms
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
the two took differently (``chip_smoke.stepwise_vs_plain``). The training
kernel (one thread-block cluster per member, activations exchanged through
distributed shared memory) also runs twice from identical buffers and must
agree bit for bit: a race on the exchange would show there. The
trainer's batched validation pass (one launch of kernels 1, 1b, 2, 2b, 5
or 5b over every full batch) gives, bit for bit, the outputs of one
launch a batch, and kernels 2 and 2b with a seed table match their plain
versions with it."""
import copy
import csv
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import (CNN_128, CNN_IMAGE, FLAGSHIP, TOL_TRAIN, cnn_model,
                        cnn_reference, image_target, member_nets,
                        read_launches, reset_launches, separate_relu,
                        stepwise_vs_plain, train_inputs, train_plan,
                        validation_case)
from nnueehcs_tpu_torch.attrib import (BINDING_CLIP, TOL_NORM, bf16_close,
                                       probe_prod, stepwise_vs_plain_bf16)
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
from nnueehcs_tpu_torch.ops import fused_eval_chain as ec
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

REPO = Path(__file__).resolve().parents[1]

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


# kernel 1b (one thread-block cluster of member-resident chains,
# csrc/fused_chain_wgmma.cuh ensemble_pass): 1 to 32 members (the resident
# cluster up to 8, the ring past it), the bench's cases, a chain too deep to
# stay resident, the requests of 1 and 300 rows, and 128 outputs
ENSEMBLE_BF16_CASES = {
    # name: (members, in_dim, width, hidden, out_dim, rows, mean shift)
    'members_1': (1, 5, 128, 6, 1, 4096, 0.0),
    'members_2': (2, 5, 128, 6, 1, 4096, 0.0),
    'members_3': (3, 5, 128, 6, 1, 4096, 0.0),
    'members_8_flagship': (8, 5, 128, 6, 1, 262_144, 0.0),
    'members_12_ring': (12, 5, 128, 6, 1, 4096, 0.0),
    'members_32_ring': (32, 5, 128, 6, 1, 1000, 0.0),
    'ragged_1000': (8, 5, 128, 6, 1, 1000, 0.0),
    'mean_1e3': (8, 5, 128, 6, 1, 4096, 1e3),
    'input_200_one_warpgroup': (8, 200, 128, 6, 1, 1000, 0.0),
    'deep_12_linears_ring': (8, 5, 128, 11, 1, 4096, 0.0),
    'request_1': (8, 5, 128, 6, 1, 1, 0.0),
    'request_300': (8, 5, 128, 6, 1, 300, 0.0),
    'out_128_resident': (3, 37, 128, 2, 128, 300, 0.0),
    'out_128_ring': (3, 5, 128, 6, 128, 300, 0.0),
    'members_5_out_9_one_linear': (5, 17, 17, 0, 9, 65, 0.0),
}


def _ensemble_bf16(card, members, in_dim, width, hidden, out_dim, shift):
    m = _model(card, members, in_dim, width, hidden, out_dim)
    if shift:
        with torch.no_grad():
            m.net.layers[-1].bias += shift
    return _both(m, prepare_fused_weights)


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(ENSEMBLE_BF16_CASES))
def test_bf16_ensemble_cluster_kernel_matches_plain_on_card(card, case):
    members, in_dim, width, hidden, out_dim, rows, shift = \
        ENSEMBLE_BF16_CASES[case]
    fw, fw32 = _ensemble_bf16(card, members, in_dim, width, hidden, out_dim,
                              shift)
    lay = ec.eval_layout('ensemble', fw.in_dim, fw.num_layers, fw.out_dim,
                         rows, torch.cuda.get_device_properties(0)
                         .multi_processor_count, members=members)
    assert lay.resident == ('ring' not in case)
    assert lay.cluster == min(members, 8)
    x = _inputs(card, rows, in_dim, False)
    before = (fused_forward_prefolded.launches,
              fused_forward_prefolded.launches_bf16)
    got = fused_forward_prefolded(fw, x)
    torch.cuda.synchronize()
    assert (fused_forward_prefolded.launches,
            fused_forward_prefolded.launches_bf16) == (before[0],
                                                       before[1] + 1)
    _bf16_pair(case, got, fused_forward_plain(fw, x),
               fused_forward_plain(fw32, x))


@pytest.mark.cuda
@pytest.mark.parametrize('members', [3, 8, 12])
def test_bf16_ensemble_cluster_kernel_gives_the_same_bits_twice_on_card(
        card, members):
    fw, _ = _ensemble_bf16(card, members, 5, 128, 6, 1, 0.0)
    x = _inputs(card, 100_000, 5, False)
    first = [t.clone() for t in fused_forward_prefolded(fw, x)]
    again = fused_forward_prefolded(fw, x)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


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


# The bf16 MC-dropout and anchored kernels (2b, 5b: warpgroup products on a
# chain held in shared memory, or streamed through a ring when too deep;
# ops/fused_eval_chain.py) at the edges of their tiles, inputs, outputs and
# depths, held to their plain versions with the same bf16 bars.
WGMMA_MC_CASES = {
    # name: (in_dim, width, hidden, out_dim, p, samples, rows, far)
    'b1_d1_one_linear': (1, 8, 0, 1, 0.2, 4, 1, False),
    'b63_d5_w96_out3': (5, 96, 1, 3, 0.3, 8, 63, False),
    'b64_d37_out128_ring': (37, 128, 6, 128, 0.1, 5, 64, False),
    'b65_w40_one_sample': (5, 40, 3, 1, 0.5, 1, 65, False),
    'b262143_flagship': (5, 128, 6, 1, 0.1, 16, 262_143, False),
    'one_linear_d37_out128': (37, 37, 0, 128, 0.1, 3, 300, False),
    'deep_12_linears_ring': (5, 128, 11, 1, 0.1, 8, 1000, False),
    'far_ood': (5, 128, 6, 1, 0.1, 32, 4096, True),
}
WGMMA_ANCHORED_CASES = {
    # name: (in_dim, width, hidden, out_dim, anchors, rows, far)
    'k1_b65': (5, 128, 6, 1, 1, 65, False),
    'k229_b262143': (5, 128, 6, 1, 229, 262_143, False),
    'b1_d1_out3': (1, 128, 2, 3, 5, 1, False),
    'b63_d37_w64_out128': (37, 64, 1, 128, 7, 63, False),   # 32 KB + 2 x 96
    'b64_w96_out3': (5, 96, 6, 3, 11, 64, False),
    'deep_12_linears_ring': (5, 128, 11, 1, 17, 1000, False),
    'far_ood': (5, 128, 6, 1, 229, 4096, True),
}
FAR = 40.0      # far_ood: every input feature moved 40 past the data


def _inputs(card, rows, in_dim, far, seed=6):
    x = np.random.default_rng(seed).normal(size=(rows, in_dim))
    return torch.as_tensor(x + (FAR if far else 0.0), dtype=torch.float32,
                           device=card)


def _form(kernel, w, rows):
    return ec.eval_layout(kernel, w.in_dim, w.num_layers, w.out_dim, rows,
                          torch.cuda.get_device_properties(0)
                          .multi_processor_count)


def _one_linear_mc(card, in_dim, out_dim, p):
    """bf16 and fp32 McWeights of one Linear with a Dropout before it (a
    chain the builder never makes, which the kernels take: the mask then
    falls on x)."""
    gen = torch.Generator().manual_seed(4)
    w = (torch.randn((1, in_dim, out_dim), generator=gen) / in_dim ** 0.5)
    b = torch.randn((1, out_dim), generator=gen) * 0.1
    folded = [(w.to(card), b.to(card), False)]
    return (mc.McWeights(folded, [p], [0], torch.bfloat16),
            mc.McWeights(folded, [p], [0], torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(WGMMA_MC_CASES))
def test_bf16_mc_wgmma_kernel_matches_plain_on_card(card, case):
    in_dim, width, hidden, out_dim, p, samples, rows, far = \
        WGMMA_MC_CASES[case]
    if hidden == 0:
        mw, mw32 = _one_linear_mc(card, in_dim, out_dim, p)
    else:
        mw, mw32 = _both(_mc_model(card, in_dim, width, hidden, out_dim, p,
                                   samples),
                         lambda net: mc.prepare_mc_weights(net))
    assert mw.num_layers == hidden + 1
    assert _form('mc', mw, rows).resident == ('ring' not in case)
    x = _inputs(card, rows, in_dim, far)
    before = (fused_mc_forward.launches, fused_mc_forward.launches_bf16)
    got = fused_mc_forward(mw, x, samples, 1234567)
    torch.cuda.synchronize()
    assert (fused_mc_forward.launches,
            fused_mc_forward.launches_bf16) == (before[0], before[1] + 1)
    _bf16_pair(case, got, fused_mc_forward_plain(mw, x, samples, 1234567),
               fused_mc_forward_plain(mw32, x, samples, 1234567))


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(WGMMA_ANCHORED_CASES))
def test_bf16_anchored_wgmma_kernel_matches_plain_on_card(card, case):
    in_dim, width, hidden, out_dim, anchors, rows, far = \
        WGMMA_ANCHORED_CASES[case]
    m = _anchored_model(card, DeltaUQMLPModelBuilder, in_dim, width, hidden,
                        out_dim, anchors)
    aw, aw32 = _both(m, lambda net: fa.prepare_fused_anchored(net))
    assert _form('anchored', aw, rows).resident == ('ring' not in case)
    x = _inputs(card, rows, in_dim, far)
    before = (fused_anchored_stats.launches,
              fused_anchored_stats.launches_bf16)
    got = fused_anchored_stats(aw, x, m.anchors)
    torch.cuda.synchronize()
    assert (fused_anchored_stats.launches,
            fused_anchored_stats.launches_bf16) == (before[0], before[1] + 1)
    _bf16_pair(case, got,
               fused_anchored_plain(aw, x, anchor_rows(aw, m.anchors)),
               fused_anchored_plain(aw32, x, anchor_rows(aw32, m.anchors)))


@pytest.mark.cuda
@pytest.mark.parametrize('seed', [0, 1234567, 2**32 - 1])
def test_bf16_mc_kernel_draws_the_plain_masks_bit_for_bit_on_card(card,
                                                                  seed):
    """A network whose output is its masks: layer 0 gives 1 everywhere, two
    Dropouts (p = 0.5, scale 2) before two identity Linears and an identity
    last Linear, so one sample's mean is 4 where both masks keep a value
    and 0 elsewhere, exactly in bf16; the kernel must equal the plain
    version bit for bit on every (row, column)."""
    arch = [{'Linear': {'args': [5, 128]}}, {'ReLU': {}},
            {'Linear': {'args': [128, 128]}}, {'ReLU': {}},
            {'Linear': {'args': [128, 128]}}, {'ReLU': {}},
            {'Linear': {'args': [128, 128]}}]
    m = MCDropoutModelBuilder(arch, {'num_samples': 1,
                                     'dropout_percent': 0.5},
                              seed=5, device=card).build()
    linears = [layer for layer in m.net.layers
               if type(layer).__name__ == 'Linear']
    with torch.no_grad():
        linears[0].weight.zero_()
        linears[0].bias.fill_(1.0)
        for layer in linears[1:]:
            layer.weight.copy_(torch.eye(128))
            layer.bias.zero_()
    m.set_precision('bf16-mixed')
    mw = mc.prepare_mc_weights(m.net)
    assert mw.compute_dtype == torch.bfloat16
    assert sum(t >= 0 for t in mw.thresholds) == 2
    x = _inputs(card, 1000, 5, False)
    mean, std = fused_mc_forward(mw, x, 1, seed)
    want, _ = fused_mc_forward_plain(mw, x, 1, seed)
    torch.cuda.synchronize()
    assert torch.equal(mean, want)
    kept = float((mean == 4.0).float().mean())
    assert set(torch.unique(mean).tolist()) == {0.0, 4.0}
    assert 0.2 < kept < 0.3                 # both masks keep 1/4 of values
    assert float(std.abs().max()) == 0.0


@pytest.mark.cuda
def test_bf16_eval_wgmma_kernels_give_the_same_bits_twice_on_card(card):
    mw, _ = _both(_mc_model(card, 5, 128, 6, 1, 0.1, 32),
                  lambda net: mc.prepare_mc_weights(net))
    m = _anchored_model(card, DeltaUQMLPModelBuilder, 5, 128, 6, 1, 229)
    aw, _ = _both(m, lambda net: fa.prepare_fused_anchored(net))
    x = _inputs(card, 20_000, 5, False)
    for run in (lambda: fused_mc_forward(mw, x, 32, 99),
                lambda: fused_anchored_stats(aw, x, m.anchors)):
        first = [t.clone() for t in run()]
        again = run()
        torch.cuda.synchronize()
        for a, b in zip(first, again):
            assert torch.equal(a, b)


# The fp32 MC-dropout and anchored kernels (2, 5: 3xTF32 wgmma products on
# a chain streamed through a ring, a tile's passes split over the
# ec.GROUPS blocks of a cluster and merged in its leader) at the edges of
# their tiles, groups, inputs, outputs and depths, held to their plain
# versions with the fp32 tolerances.
TF32_MC_CASES = {
    # name: (in_dim, width, hidden, out_dim, p, samples, rows, far)
    'b1': (5, 128, 6, 1, 0.1, 128, 1, False),
    'b63_out3': (5, 96, 1, 3, 0.3, 16, 63, False),
    'b64_d37_out128': (37, 128, 6, 128, 0.1, 9, 64, False),
    'b65_one_sample': (5, 40, 3, 1, 0.5, 1, 65, False),
    'b128_two_samples': (5, 128, 6, 1, 0.1, 2, 128, False),
    'b128_groups_less_one': (5, 128, 6, 9, 0.1, ec.GROUPS - 1, 128, False),
    'b128_groups': (5, 128, 6, 1, 0.1, ec.GROUPS, 128, False),
    'b12800_flagship': (5, 128, 6, 1, 0.1, 128, 12_800, False),
    'b1000_129_samples': (5, 128, 6, 2, 0.1, 129, 1000, False),
    'one_linear_d37_out128': (37, 37, 0, 128, 0.1, 3, 300, False),
    'wide_input_200': (200, 128, 2, 1, 0.2, 9, 300, False),
    'deep_12_linears': (5, 128, 11, 1, 0.1, 8, 1000, False),
    'far_ood': (5, 128, 6, 1, 0.1, 32, 4096, True),
}
TF32_ANCHORED_CASES = {
    # name: (in_dim, width, hidden, out_dim, anchors, rows, far)
    'k1_b65': (5, 128, 6, 1, 1, 65, False),
    'k2_b1': (5, 128, 6, 1, 2, 1, False),
    'k7_b63_out3': (5, 64, 1, 3, ec.GROUPS - 1, 63, False),
    'k8_b64': (5, 128, 6, 1, ec.GROUPS, 64, False),
    'k9_b128_out9': (5, 128, 6, 9, ec.GROUPS + 1, 128, False),
    'k229_b128': (5, 128, 6, 1, 229, 128, False),
    'k229_b12800': (5, 128, 6, 1, 229, 12_800, False),
    'k17_d37_out128': (37, 64, 1, 128, 17, 300, False),
    'wide_input_100': (100, 128, 2, 1, 17, 129, False),
    'deep_12_linears': (5, 128, 11, 1, 17, 1000, False),
    'far_ood': (5, 128, 6, 1, 229, 4096, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(TF32_MC_CASES))
def test_tf32_mc_kernel_matches_plain_on_card(card, case):
    in_dim, width, hidden, out_dim, p, samples, rows, far = \
        TF32_MC_CASES[case]
    if hidden == 0:
        _, mw = _one_linear_mc(card, in_dim, out_dim, p)
    else:
        mw = _mc_model(card, in_dim, width, hidden, out_dim, p,
                       samples).mc_weights()
    assert mw.compute_dtype == torch.float32
    assert mw.num_layers == hidden + 1
    x = _inputs(card, rows, in_dim, far)
    before = (fused_mc_forward.launches, fused_mc_forward.launches_bf16)
    mean, std = fused_mc_forward(mw, x, samples, 1234567)
    torch.cuda.synchronize()
    assert (fused_mc_forward.launches,
            fused_mc_forward.launches_bf16) == (before[0] + 1, before[1])
    ref_mean, ref_std = fused_mc_forward_plain(mw, x, samples, 1234567)
    torch.testing.assert_close(mean, ref_mean, **TOL_MEAN)
    torch.testing.assert_close(std, ref_std, **TOL_STD)
    if samples == 1:
        assert float(std.abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(TF32_ANCHORED_CASES))
def test_tf32_anchored_kernel_matches_plain_on_card(card, case):
    in_dim, width, hidden, out_dim, anchors, rows, far = \
        TF32_ANCHORED_CASES[case]
    m = _anchored_model(card, DeltaUQMLPModelBuilder, in_dim, width, hidden,
                        out_dim, anchors)
    aw = m.anchored_weights()
    assert aw.compute_dtype == torch.float32
    x = _inputs(card, rows, in_dim, far)
    before = (fused_anchored_stats.launches,
              fused_anchored_stats.launches_bf16)
    mean, std = fused_anchored_stats(aw, x, m.anchors)
    torch.cuda.synchronize()
    assert (fused_anchored_stats.launches,
            fused_anchored_stats.launches_bf16) == (before[0] + 1, before[1])
    ref_mean, ref_std = fused_anchored_plain(aw, x, anchor_rows(aw, m.anchors))
    torch.testing.assert_close(mean, ref_mean, **TOL_MEAN)
    torch.testing.assert_close(std, ref_std, **TOL_STD)
    if anchors == 1:
        assert float(std.abs().max()) == 0.0


@pytest.mark.cuda
def test_tf32_kernels_give_the_same_bits_twice_on_card(card):
    """Kernels 2 and 5 twice on the same rows, bit for bit: a race in the
    ring or in the leader's merge would show here."""
    mw = _mc_model(card, 5, 128, 6, 3, 0.1, 37).mc_weights()
    m = _anchored_model(card, DeltaUQMLPModelBuilder, 5, 128, 6, 1, 229)
    aw = m.anchored_weights()
    x = _inputs(card, 20_000, 5, False)
    for run in (lambda: fused_mc_forward(mw, x, 37, 99),
                lambda: fused_anchored_stats(aw, x, m.anchors)):
        first = [t.clone() for t in run()]
        again = run()
        torch.cuda.synchronize()
        for a, b in zip(first, again):
            assert torch.equal(a, b)


TF32_ENSEMBLE_CASES = {
    # name: (members, in_dim, width, hidden, out_dim, rows, far)
    'm1_b1': (1, 5, 128, 6, 1, 1, False),
    'm1_b4096': (1, 5, 128, 6, 1, 4096, False),
    'm2_b63_d13': (2, 13, 64, 1, 1, 63, False),
    'm3_b65_out9': (3, 5, 128, 6, 9, 65, False),
    'm3_one_linear_out9': (3, 13, 13, 0, 9, 300, False),
    'm8_b128': (8, 5, 128, 6, 1, 128, False),
    'm8_b4096': (8, 5, 128, 6, 1, 4096, False),
    'm8_b12800': (8, 5, 128, 6, 1, 12_800, False),
    'm8_d37_out128': (8, 37, 64, 1, 128, 300, False),
    'm8_deep_12_linears': (8, 5, 128, 11, 1, 1000, False),
    'm8_far_ood': (8, 5, 128, 6, 1, 4096, True),
    'm9_b1000_out9': (9, 13, 128, 1, 9, 1000, False),
    'm15_b4096': (15, 5, 128, 6, 1, 4096, False),
    'm28_b4096': (28, 5, 128, 6, 1, 4096, False),
    'm3_wide_input_200': (3, 200, 128, 2, 1, 1000, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(TF32_ENSEMBLE_CASES))
def test_tf32_ensemble_kernel_matches_plain_on_card(card, case):
    """Kernel 1 (3xTF32, a cluster of min(M, 8) member blocks) against its
    plain version at the edges of its tiles, clusters (one member; more
    members than blocks), inputs, outputs and depths."""
    members, in_dim, width, hidden, out_dim, rows, far = \
        TF32_ENSEMBLE_CASES[case]
    fw = prepare_fused_weights(_model(card, members, in_dim, width, hidden,
                                      out_dim).net)
    assert fw.compute_dtype == torch.float32
    assert fw.num_layers == hidden + 1
    x = _inputs(card, rows, in_dim, far)
    before = (fused_forward_prefolded.launches,
              fused_forward_prefolded.launches_bf16)
    mean, std = fused_forward_prefolded(fw, x)
    torch.cuda.synchronize()
    assert (fused_forward_prefolded.launches,
            fused_forward_prefolded.launches_bf16) == (before[0] + 1,
                                                       before[1])
    ref_mean, ref_std = fused_forward_plain(fw, x)
    torch.testing.assert_close(mean, ref_mean, **TOL_MEAN)
    torch.testing.assert_close(std, ref_std, **TOL_STD)
    if members == 1:
        assert float(std.abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize('members', [3, 8, 9, 28])
def test_tf32_ensemble_kernel_gives_the_same_bits_twice_on_card(card,
                                                                members):
    """Kernel 1 twice on the same rows, and once over 12,800 rows against
    one launch a 128-row batch, bit for bit: a race in the ring or the
    exchange, or a row's arithmetic that depends on B, would show here."""
    fw = prepare_fused_weights(_model(card, members, 5, 128, 6, 1).net)
    x = _inputs(card, 12_800, 5, False)
    first = [t.clone() for t in fused_forward_prefolded(fw, x)]
    again = fused_forward_prefolded(fw, x)
    batches = [fused_forward_prefolded(fw, x[r:r + 128].contiguous())
               for r in range(0, x.shape[0], 128)]
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(first, again)):
        assert torch.equal(a, b)
        assert torch.equal(a, torch.cat([t[i] for t in batches]))


@pytest.mark.cuda
def test_tf32_kernels_compile_without_spills_and_with_hgmma(card):
    """ptxas's report of the fp32 kernels 1, 2 and 5: no spill, HGMMA
    (wgmma) instructions in their SASS, and none serialised (no wait after
    most HGMMA, no ptxas C75xx warning; nnueehcs_tpu_torch.sass)."""
    from chip_smoke import ptxas_report
    from nnueehcs_tpu_torch.ops import _build
    from nnueehcs_tpu_torch.sass import (TF32_KERNELS, dump,
                                         eval_chain_rows, parse_instructions)
    info = _build.build_info()
    rows = eval_chain_rows(parse_instructions(dump(info.path)),
                           ptxas_report(info.log), info.log)
    for kernel in TF32_KERNELS:
        assert rows[kernel]['spill_store_bytes'] == 0
        assert rows[kernel]['spill_load_bytes'] == 0
        assert rows[kernel]['hgmma'] > 0
        assert 2 * rows[kernel]['hgmma_waited'] <= rows[kernel]['hgmma']
        assert rows[kernel]['ptxas_serialised'] == []


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
    # the tensor-core path at every d <= 8 (one k step of 8 up to d = 6,
    # two at 7 and 8), counts that are multiples of no tile, one query
    'd2_ragged': (1001, 3001, 2, 0.0, False),
    'd3_ragged': (1001, 3001, 3, 0.0, False),
    'd4_ragged': (1001, 3001, 4, 0.0, False),
    'd5_ragged': (1001, 3001, 5, 0.0, False),
    'd7_ragged': (1001, 3001, 7, 0.0, False),
    'd8_far_ood': (1001, 3001, 8, 0.0, True),
    'd5_one_query': (1, 3001, 5, 0.0, False),
    'd6_offset_1e3_one_query': (1, 257, 6, 1e3, False),
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
    # the probes' math is kernel 1's former FFMA body, which the prod probe
    # runs; kernel 1 itself (3xTF32) is held to its plain version
    mean, std = (t[:, :out_dim] for t in af.ablate_forward(
        fw, _padded(x, 128)))
    got = fused_forward_prefolded(fw, x)
    want = fused_forward_plain(fw, x)
    torch.testing.assert_close(got[0], want[0], **TOL_MEAN)
    torch.testing.assert_close(got[1], want[1], **TOL_STD)
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
        if got[0].shape[0] == rows:          # the prod probe's, bit for bit
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
    """The probe's prod runs the one-block form of kernel 3 (the form the
    production kernel had before its cluster form; the two no longer share
    code, so they are not compared bit for bit). On the flagship as built,
    the probe's prod is held bit for bit to a second run and to the same
    one-block bodies replayed as a CUDA graph, and, like the production
    kernel, step by step to the plain version."""
    m = EnsembleModelBuilder(FLAGSHIP, {'num_models': 8}, seed=3,
                             device=card).build()
    plan = train_plan(m)
    bufs, xs, ys = train_inputs(m, plan, np.random.default_rng(15), 40)
    got = ae.ablate_epoch(plan, *[b.clone() for b in bufs], xs, ys, 1e-3, 5)
    for again in (ae.ablate_epoch(plan, *[b.clone() for b in bufs], xs, ys,
                                  1e-3, 5),
                  ae.ablate_epoch(plan, *[b.clone() for b in bufs], xs, ys,
                                  1e-3, 5, unroll=4)):
        for a, b in zip(got, again):
            assert torch.equal(a, b)
    for epoch in (probe_prod, None):
        out = stepwise_vs_plain(plan, bufs, xs[:8], ys[:8], 1e-3, 5, 0, None,
                                epoch=epoch)
        assert out['over_tol_outside_reach'] == 0


# shapes only the cluster kernel's layout separates: a last layer wider than
# one block's lanes (several blocks own lanes below out_pad and run the
# loss), and a single Linear (no exchange before the weight gradient)
# name: (members, width, hidden, out_dim, batch, loss, per_member)
LAYOUT_TRAIN_CASES = {
    'out_20_joint_mse': (3, 32, 2, 20, 24, 'mse_loss', False),
    'out_40_per_member_l1': (2, 64, 2, 40, 40, 'l1_loss', True),
    'single_linear_out_3': (2, 0, 0, 3, 16, 'l1_loss', False),
}


@pytest.mark.cuda
@pytest.mark.parametrize('bf16', [False, True])
@pytest.mark.parametrize('case', sorted(LAYOUT_TRAIN_CASES))
def test_training_kernel_layout_cases_on_card(card, case, bf16):
    """fp32: a whole epoch against the plain one on a network whose
    pre-ReLU values sit away from 0; bf16: step by step on the network as
    built; and each form twice, bit for bit."""
    members, width, hidden, out_dim, batch, loss, per_member = \
        LAYOUT_TRAIN_CASES[case]
    m = EnsembleModelBuilder(_arch(5, width, hidden, out_dim),
                             {'num_models': members}, seed=5,
                             device=card).build()
    if not bf16:
        separate_relu(_randomize_bn(m), torch.Generator().manual_seed(11))
    plan = ft.plan_fused_train(m.net, members, batch, loss=loss,
                               per_member=per_member, clip=5.0, bf16=bf16)
    layout = ft.train_layout(plan)
    assert layout.out_blocks == -(-plan.out_pad // layout.lanes)
    bufs, xs, ys = train_inputs(m, plan, np.random.default_rng(22), 6)
    if bf16:
        stepwise_vs_plain(plan, bufs, xs, ys, 1e-3, 5, 9, None)
    else:
        got = ft.fused_epoch(plan, *[b.clone() for b in bufs], xs, ys, 1e-3,
                             5)
        want = ft.fused_epoch_reference(plan, *[b.clone() for b in bufs], xs,
                                        ys, 1e-3, 5)
        for (name, tol), a, b in zip(TOL_TRAIN.items(), got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=tol, msg=name)
    runs = [ft.fused_epoch(plan, *[b.clone() for b in bufs], xs, ys, 1e-3, 5)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# the cluster kernel twice from identical buffers: every output and every
# recorded ReLU decision bit for bit (fixed summation orders, no float
# atomics; a race on the exchanged activations would show here)
DETERMINISM_CASES = {
    'flagship': TRAIN_CASES['flagship_joint_l1'],
    'batch_8': ('ensemble', 32, 2, 3, 8, 'l1_loss', False, 0.0, 0.0),
    'batch_40': TRAIN_CASES['batch_40'],
    'mve': TRAIN_CASES['flagship_mve'],
    'mc_dropout': TRAIN_CASES['flagship_mc_p01'],
    'anchored_single_net_b256': None,
}


@pytest.mark.cuda
@pytest.mark.parametrize('bf16', [False, True])
@pytest.mark.parametrize('case', sorted(DETERMINISM_CASES))
def test_training_kernel_is_deterministic_on_card(card, case, bf16):
    if case == 'anchored_single_net_b256':
        m = DeltaUQMLPModelBuilder(FLAGSHIP, {'num_anchors': 16}, seed=5,
                                   device=card).build()
        plan = ft.plan_fused_train(m.net, 1, 256, clip=5.0, bf16=bf16,
                                   member_stacked=False)
        assert plan.in_pad == 16
        bufs, xs, ys = train_inputs(m, plan, np.random.default_rng(21), 6,
                                    anchored=True)
    else:
        family, width, hidden, members, batch, loss, per_member, wd, p = \
            DETERMINISM_CASES[case]
        m = _train_model(card, family, width, hidden, members, p)
        plan = ft.plan_fused_train(m.net, members, batch, loss=loss,
                                   per_member=per_member, clip=5.0,
                                   weight_decay=wd, bf16=bf16,
                                   member_stacked=family == 'ensemble')
        bufs, xs, ys = train_inputs(m, plan, np.random.default_rng(21), 6)
    drops = ft.drop_rates(m.net).to(card)
    shape = (xs.shape[0], plan.num_members, plan.n_bn, plan.batch, ft.LANES)
    runs = []
    for _ in range(2):
        signs = torch.zeros(shape, dtype=torch.uint8, device=card)
        out = ft.fused_epoch(plan, *[b.clone() for b in bufs], xs, ys, 1e-3, 5,
                             seed=77, drops=drops, signs=signs)
        runs.append((*out, signs))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(runs[0][4]).all())
    for a, b in zip(*runs):
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
    # a clipped l1 plan's step is launched twice: the second launch,
    # unclipped, reads the l1 decisions the clip can hide
    per_step = 2 if plan.loss == 'l1_loss' and plan.clip is not None else 1
    assert (ft.fused_epoch.launches, ft.fused_epoch.launches_bf16) == \
        (before[0], before[1] + 6 * per_step)
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


# kernel 3b on the MC-dropout flagship with every pre-ReLU value kept off 0
# (``separate_relu``), 64 steps, with the witnessed bars
# (``attrib.stepwise_vs_plain_bf16``: each step's bars widened by how far
# the host's plain step and the tensor cores' part from the card's plain
# step on that step, the excursions past them capped in reach and number);
# each planted fault of tools/bf16_mc_stepwise.py fails them: the learning
# rate doubled on every step or on step 17 alone past an excursion's bar,
# half the gap on every step by the count
def _mc_tool():
    spec = importlib.util.spec_from_file_location(
        'bf16_mc_stepwise', REPO / 'tools' / 'bf16_mc_stepwise.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.cuda
@pytest.mark.parametrize('seed', [0, 1])
def test_training_kernel_bf16_on_separate_relu_mc_dropout_on_card(card,
                                                                   seed):
    model = separate_relu(
        MCDropoutModelBuilder(FLAGSHIP, {'num_samples': 128,
                                         'dropout_percent': 0.1},
                              seed=seed, device=card).build(),
        torch.Generator().manual_seed(seed + 7))
    plan = train_plan(model, bf16=True)
    assert plan.n_drop == 5
    bufs, xs, ys = train_inputs(model, plan, np.random.default_rng(seed), 64)
    drops = ft.drop_rates(model.net).to(card)
    out = stepwise_vs_plain_bf16(plan, bufs, xs, ys, 1e-3, 5, 4242, drops,
                                 witnessed=True)
    assert out['failures'] == []
    assert out['excursions']['steps'] <= out['excursions']['allowed']
    tool = _mc_tool()
    for plant, (lr_scale, gap_share, steps) in tool.PLANTS.items():
        fault = stepwise_vs_plain_bf16(
            plan, bufs, xs, ys, 1e-3, 5, 4242, drops, gate=False,
            witnessed=True,
            epoch=tool.planted_fault(ft, lr_scale, gap_share, steps, first=5))
        if plant == 'gap':
            assert 'excursions past' in fault['failures'][-1], plant
        else:
            assert fault['first_failed_step'] == (steps or (0,))[0], plant


# CNN-128 (chip_smoke.CNN_128: 1 x 8 x 8 images, two 3 x 3 convolutions 128
# channels wide) through the four UQ classes on the card: no kernel takes a
# Conv2d network, so every launch count stays 0; the answers against the
# plain computation member by member and anchor by anchor
# (``chip_smoke.cnn_reference``), mean 1e-5, UE 1e-3 relative + 1e-5
CNN_KINDS = ('ensemble', 'mc_dropout', 'delta_uq', 'pager')


def _cnn(kind, card, seed=0):
    model = cnn_model(kind, CNN_128, seed).to(card)
    if kind in ('delta_uq', 'pager'):
        rng = np.random.default_rng(seed + 1)
        model.anchors = rng.normal(size=(229,) + CNN_IMAGE).astype(
            np.float32)
        if kind == 'pager':
            model.anchors_Y = rng.normal(size=(229, 1)).astype(np.float32)
    return model


@pytest.mark.cuda
@pytest.mark.parametrize('kind', CNN_KINDS)
def test_cnn128_serves_as_the_plain_computation_on_card(card, kind):
    model = _cnn(kind, card)
    nets = member_nets(model) if kind == 'ensemble' else \
        [copy.deepcopy(model.net)] if kind == 'mc_dropout' else None
    x = np.random.default_rng(3).normal(size=(300,) + CNN_IMAGE).astype(
        np.float32)
    reset_launches()
    pred = Predictor(model, buckets=(256, 1024), device=card, warmup=False)
    pred.warmup(CNN_IMAGE)
    call = getattr(model, '_eval_calls', None)
    mean, ue = pred.predict(x)
    assert set(read_launches().values()) == {0}
    ref_mean, ref_ue = cnn_reference(model, nets, torch.from_numpy(x).to(card),
                                     call, None)
    torch.testing.assert_close(torch.from_numpy(mean), ref_mean.cpu(),
                               **TOL_MEAN)
    torch.testing.assert_close(torch.from_numpy(ue), ref_ue.cpu(), **TOL_STD)


@pytest.mark.cuda
@pytest.mark.parametrize('kind', CNN_KINDS)
def test_cnn128_trains_an_epoch_on_card_as_on_the_cpu(card, kind, tmp_path):
    """Eight unshuffled steps of 32 images from the same build on the card
    and on the CPU: no kernel epoch, no launch; the per-step losses within
    1e-4 (two fp32 trajectories, as chip_smoke's TOL_CROSS; MC dropout's
    masks come from each device's own generator, so its losses are held
    only to be finite), Δ-UQ and PAGER anchored by the same permutations."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(256,) + CNN_IMAGE).astype(np.float32)
    y = image_target(x)
    perms = ft.anchor_permutations(torch.Generator().manual_seed(9), 8, 32)
    losses = {}
    for device in (card, torch.device('cpu')):
        model = cnn_model(kind, CNN_128, 0).to(device)
        trainer = Trainer('t', {'max_epochs': 1, 'limit_train_batches': 8,
                                'gradient_clip_val': 5.0,
                                'log_every_n_steps': 1},
                          callbacks=model.get_callbacks(),
                          log_dir=str(tmp_path), version=device.type,
                          device=device)
        trainer.anchor_permutations = \
            lambda epoch, first, steps, batch, d=device: \
            perms[first:first + steps].to(d)
        reset_launches()
        trainer.fit(model, DataLoader(ArrayDataset(x, y), 32,
                                      drop_last=True),
                    DataLoader(ArrayDataset(x[:64], y[:64]), 32))
        assert set(read_launches().values()) == {0}
        assert trainer.fused_epochs_used == 0
        with open(f'{trainer.logger.log_dir}/metrics.csv') as f:
            losses[device.type] = np.array([
                float(r['train_loss']) for r in csv.DictReader(f)
                if r.get('train_loss')])
    assert losses['cuda'].shape == (8,)
    assert np.isfinite(losses['cuda']).all()
    if kind != 'mc_dropout':
        np.testing.assert_allclose(losses['cuda'], losses['cpu'], rtol=0,
                                   atol=1e-4)


# ``parallel/`` on the card: a gloo world of two ranks on one card (NCCL
# refuses two ranks on a card), and an NCCL world of one rank a card. The
# rank bodies live in tests/torch_parallel_cases.py (no JAX there either).
PARALLEL_ROWS = 70_000            # one ragged bucket of 131,072 rows


@pytest.fixture(scope='module')
def gloo_card_world():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    import torch_parallel_cases as cases
    from nnueehcs_tpu_torch.parallel import launch
    return launch(cases.card_cases, 2, backend='gloo',
                  devices=['cuda:0', 'cuda:0'], all_ranks=True,
                  timeout=cases.WORLD_TIMEOUT, args=(PARALLEL_ROWS,))


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['fused_ensemble', 'fused_mc_dropout',
                                  'kde'])
def test_dp_sharded_models_on_card_match_the_unsharded_call(gloo_card_world,
                                                            name):
    """Each rank launched its kernel once for the bucket, on its half of
    the rows (kernel 4 on its corpus shard), every rank holds the whole
    answer, and the answer is the unsharded call's: MC dropout bit for
    bit (each rank hashes its rows from row0), the ensemble bit for bit
    (rows are independent), KDE within its bar (the corpus merge reorders
    sums)."""
    first = None
    for want, got, launches in (rank[name] for rank in gloo_card_world):
        assert launches == {k: int(k == name) for k in launches}
        if first is None:
            first = got
        for a, b in zip(got, first):
            np.testing.assert_array_equal(a, b)
        if name == 'kde':
            np.testing.assert_allclose(got[0], want[0], rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(got[1], want[1], rtol=2e-4,
                                       atol=1e-30)
        else:
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize('bf16', [False, True])
def test_mc_kernel_row0_is_the_rows_place_in_the_whole_call(card, bf16):
    """Kernels 2 and 2b with a nonzero row0 against their plain version,
    and a tail of the rows launched from its row0 equal to the same rows
    of the whole call, bit for bit."""
    m = MCDropoutModelBuilder(_arch(5, 64, 3, 1), {'num_samples': 32,
                                                   'dropout_percent': 0.2},
                              seed=3, device=card).build()
    if bf16:
        m.set_precision('bf16-mixed')
    mw = m.mc_weights()
    x = torch.randn(5000, 5, device=card)
    got = fused_mc_forward(mw, x, 32, 77, row0=123_457)
    want = fused_mc_forward_plain(mw, x, 32, 77, row0=123_457)
    whole = fused_mc_forward(mw, x, 32, 77)
    tail = fused_mc_forward(mw, x[1234:].contiguous(), 32, 77, row0=1234)
    torch.cuda.synchronize()
    if bf16:
        m32 = MCDropoutModelBuilder(_arch(5, 64, 3, 1), {
            'num_samples': 32, 'dropout_percent': 0.2}, seed=3,
            device=card).build()
        ref32 = fused_mc_forward_plain(m32.mc_weights(), x, 32, 77,
                                       row0=123_457)
        for part, g, w, r in zip(('mean', 'std'), got, want, ref32):
            bf16_close(f'2b row0 {part}', g, w, r)
    else:
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got[1], want[1], rtol=1e-3, atol=1e-5)
    for a, b in zip(whole, tail):
        assert torch.equal(a[1234:], b)
    assert not torch.equal(got[1], whole[1])


@pytest.mark.cuda
def test_nccl_world_of_every_card(card):
    """One NCCL rank a visible card: the world's sum reaches every rank;
    two NCCL ranks on one card are refused with ValueError, not moved to
    gloo."""
    import torch_parallel_cases as cases
    from nnueehcs_tpu_torch.parallel import launch
    count = torch.cuda.device_count()
    sums = launch(cases.nccl_sum, count, backend='nccl', all_ranks=True,
                  timeout=240)
    assert [s for s, _ in sums] == [count * (count + 1) / 2] * count
    assert [d for _, d in sums] == [f'cuda:{i}' for i in range(count)]
    with pytest.raises(ValueError, match='duplicate GPU'):
        launch(cases.nccl_sum, 2, backend='nccl',
               devices=['cuda:0', 'cuda:0'],
               timeout=240)


@pytest.mark.cuda
@pytest.mark.parametrize('bf16', [False, True], ids=['fp32', 'bf16'])
def test_training_kernel_stop_and_device_lr_on_card(card, bf16):
    """Kernels 3 and 3b with ``stop`` set: every launch of the epoch
    returns at once, theta, m, v and sigma bit for bit as they were and no
    loss written; with ``stop`` clear and the learning rate read from the
    card, the epoch is the host learning rate's bit for bit."""
    m = EnsembleModelBuilder(FLAGSHIP, {'num_models': 8}, seed=3,
                             device=card).build()
    plan = train_plan(m, bf16=bf16)
    bufs, xs, ys = train_inputs(m, plan, np.random.default_rng(12), 16)
    before = [b.clone() for b in bufs]
    lr = torch.full((1,), 1e-3, dtype=torch.float32, device=card)
    ft.fused_epoch(plan, *bufs, xs, ys, lr, 5,
                   stop=torch.ones(1, dtype=torch.int32, device=card))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(bufs, before))
    host = ft.fused_epoch(plan, *[b.clone() for b in before], xs, ys, 1e-3, 5)
    card_lr = ft.fused_epoch(plan, *[b.clone() for b in before], xs, ys, lr,
                             5, stop=torch.zeros(1, dtype=torch.int32,
                                                 device=card))
    for a, b in zip(host, card_lr):
        assert torch.equal(a, b)


# the trainer's validation pass in one launch (models/base.py
# validation_losses): (builder, width, hidden, rows a batch, batches)
VALIDATION_CASES = {
    'ensemble_bs128': ('ensemble', 32, 2, 128, 12),
    'ensemble_bs100': ('ensemble', 32, 2, 100, 12),
    'mc_bs128': ('mc', 32, 2, 128, 12),
    'mc_bs100': ('mc', 32, 2, 100, 12),
    'mc_bs7': ('mc', 32, 2, 7, 40),
    'delta_uq_bs128': ('delta_uq', 32, 2, 128, 12),
}


def _validation_model(card, kind, width, hidden):
    if kind == 'ensemble':
        return _model(card, 3, 5, width, hidden, 1)
    if kind == 'mc':
        return _mc_model(card, 5, width, hidden, 1, 0.2, 16)
    return _anchored_model(card, DeltaUQMLPModelBuilder, 5, width, hidden, 1,
                           9)


@pytest.mark.cuda
@pytest.mark.parametrize('precision', ['32-true', 'bf16-mixed'])
@pytest.mark.parametrize('case', sorted(VALIDATION_CASES))
def test_batched_validation_is_the_per_batch_launches_on_card(card, case,
                                                              precision):
    """Kernels 1, 1b, 2, 2b, 5 and 5b: one launch over every batch gives,
    bit for bit, the outputs of one launch a batch (each row's arithmetic
    stays in its tile; MC dropout draws each batch with its seed through
    the seed table, also where a tile spans batches), and the batched
    losses the per-batch ones within 1e-6 relative
    (``chip_smoke.validation_case``)."""
    kind, width, hidden, bs, nb = VALIDATION_CASES[case]
    m = _validation_model(card, kind, width, hidden)
    m.set_precision(precision)
    rng = np.random.default_rng(14)
    x = rng.normal(size=(nb * bs, 5)).astype(np.float32)
    xs = torch.as_tensor(x, device=card).reshape(nb, bs, 5)
    ys = torch.as_tensor(np.sin(x).sum(1, keepdims=True),
                         device=card).reshape(nb, bs, 1)
    seeds = [(977 * b + 5) * 2654435761 % 2**32 for b in range(nb)]
    got = validation_case(case, m, xs, ys, seeds)
    assert got['launches_batched'] == 1 and got['launches_per_batch'] == nb


@pytest.mark.cuda
@pytest.mark.parametrize('bf16', [False, True], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('bs', [128, 100, 3])
def test_mc_seed_table_kernel_matches_plain_on_card(card, bf16, bs):
    """Kernels 2 and 2b with a seed table (and a row offset) against their
    plain versions with the same table."""
    m = _mc_model(card, 5, 128, 3, 1, 0.2, 32)
    mw32 = m.mc_weights()
    if bf16:
        m.set_precision('bf16-mixed')
    mw = m.mc_weights()
    rows, row0 = 1000, 37
    x = torch.as_tensor(np.random.default_rng(15).normal(size=(rows, 5)),
                        dtype=torch.float32, device=card)
    seeds = [(b * 7919 + 13) % 2**32 for b in range((rows + row0) // bs + 1)]
    got = fused_mc_forward(mw, x, 32, 0, row0, seeds, bs)
    want = fused_mc_forward_plain(mw, x, 32, 0, row0, seeds, bs)
    if not bf16:
        torch.testing.assert_close(got[0], want[0], **TOL_MEAN)
        torch.testing.assert_close(got[1], want[1], **TOL_STD)
        return
    ref = fused_mc_forward_plain(mw32, x, 32, 0, row0, seeds, bs)
    for part, g, w, r in zip(('mean', 'std'), got, want, ref):
        bf16_close(f'2b seed table {part}', g, w, r)


@pytest.mark.cuda
@pytest.mark.parametrize('tail', [0, 37])
def test_trainer_validation_pass_launches_once_on_card(card, tail, tmp_path):
    """``Trainer._val_losses``: one kernel launch for the full batches, one
    more for a partial tail, and the losses of one launch a batch."""
    m = _model(card, 3, 5, 32, 2, 1)
    bs, nb = 128, 10
    rng = np.random.default_rng(16)
    n = nb * bs + tail
    x = torch.as_tensor(rng.normal(size=(n, 5)), dtype=torch.float32,
                        device=card)
    y = torch.sin(x).sum(1, keepdim=True)
    tr = Trainer('t', {}, callbacks=[], log_dir=str(tmp_path), device=card)
    before = fused_forward_prefolded.launches
    got = tr._val_losses(m, x, y, bs, nb + (tail > 0), 0)
    torch.cuda.synchronize()
    assert fused_forward_prefolded.launches == before + 1 + (tail > 0)
    want = torch.stack([m.validation_loss((x[lo:lo + bs], y[lo:lo + bs]))
                        for lo in range(0, n, bs)])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
