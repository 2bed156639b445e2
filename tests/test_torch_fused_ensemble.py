"""The port's fused ensemble eval on the CPU (BatchNorm folding and the
kernel's plain version) against the JAX package's fused kernel, run in
Pallas interpret mode as tests/test_fused_ensemble.py runs it, and against
the JAX per-member reference. The kernel itself is held to the plain version
on a card by tests/test_torch_cuda.py. Tolerances: mean 1e-5 absolute and relative; std
1e-3 relative, 1e-5 absolute (the shifted one-pass variance against the
two-pass reference)."""
import numpy as np
import pytest
import torch

from nnueehcs_tpu.ops.fused_ensemble import (fused_ensemble_eval,
                                             prepare_fused_weights as
                                             jax_prepare_fused_weights)
from nnueehcs_tpu_torch.model_builder import EnsembleModelBuilder
from nnueehcs_tpu_torch.ops.fused_ensemble import (fused_forward_plain,
                                                   fused_forward_prefolded,
                                                   prepare_fused_weights,
                                                   shifted_stats)

from torch_parity import (TOL_MEAN, TOL_STD, assert_ue_close, descr,
                          jax_ensemble, member_outputs, port_of)


@pytest.mark.parametrize('in_dim,rows', [(5, 300), (40, 1100), (200, 300)])
def test_fold_and_plain_match_jax_fused_kernel(in_dim, rows):
    jm = jax_ensemble(descr(in_dim=in_dim, width=32, hidden=2), members=3)
    x = np.random.default_rng(7).normal(size=(rows, in_dim)).astype(np.float32)
    ref = fused_ensemble_eval(jm.net, jm.params, jm.state, x, layout='xt',
                              interpret=True)
    fw = prepare_fused_weights(port_of(jm).net)
    got = fused_forward_prefolded(fw, torch.from_numpy(x))
    assert_ue_close(got, ref)
    outs = member_outputs(jm, x)
    assert_ue_close(got, (outs.mean(0), outs.std(0, ddof=1)))


def test_large_mean_keeps_its_std():
    """|mean| >> std: a +1e3 bias on the last layer must not cancel the
    member spread (the reason for the shifted sums)."""
    jm = jax_ensemble(descr(in_dim=5, width=32, hidden=2), members=4, seed=3)
    params = list(jm.params)
    params[-1] = dict(params[-1], b=params[-1]['b'] + 1e3)
    jm.params = tuple(params)
    jm.invalidate_cache()
    x = np.random.default_rng(8).normal(size=(300, 5)).astype(np.float32)
    fw = prepare_fused_weights(port_of(jm).net)
    mean, std = fused_forward_prefolded(fw, torch.from_numpy(x))
    assert float(mean.abs().min()) > 900
    outs = member_outputs(jm, x).astype(np.float64)
    assert_ue_close((mean, std), (outs.mean(0), outs.std(0, ddof=1)))
    ref = fused_ensemble_eval(jm.net, jm.params, jm.state, x, layout='xt',
                              interpret=True)
    assert_ue_close((mean, std), ref)


def test_shifted_stats_no_cancellation():
    rng = np.random.default_rng(0)
    base = 1000.0 + rng.normal(size=(64, 1)) * 0.01
    members = torch.tensor(base + rng.normal(size=(8, 64, 1)) * 0.01,
                           dtype=torch.float32)
    d = members - members[0]
    mean, std = shifted_stats(d.sum(0), (d * d).sum(0), members[0], 8)
    ref = members.double().numpy()
    np.testing.assert_allclose(mean.numpy(), ref.mean(0), rtol=1e-6)
    np.testing.assert_allclose(std.numpy(), ref.std(0, ddof=1), rtol=1e-3)


def test_cpu_tensor_runs_the_plain_version_without_a_launch():
    m = EnsembleModelBuilder(descr(), {'num_models': 3}, device='cpu').build()
    fw = prepare_fused_weights(m.net)
    x = torch.randn(50, 5, generator=torch.Generator().manual_seed(0))
    before = fused_forward_prefolded.launches
    got = fused_forward_prefolded(fw, x)
    want = fused_forward_plain(fw, x)
    assert fused_forward_prefolded.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    m = EnsembleModelBuilder(descr(), {'num_models': 2}, device='cpu').build()
    fw = prepare_fused_weights(m.net)
    with pytest.raises(TypeError, match='float32'):
        fused_forward_prefolded(fw, torch.zeros(4, 5, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        fused_forward_prefolded(fw, torch.zeros(4, 5, dtype=torch.float64))
    with pytest.raises(ValueError, match='shape'):
        fused_forward_prefolded(fw, torch.zeros(4, 6))
    with pytest.raises(ValueError, match='contiguous'):
        fused_forward_prefolded(fw, torch.zeros(5, 4).t())


def test_packing_matches_the_kernel_layout():
    layers = descr(in_dim=7, width=32, hidden=3, out_dim=2)
    m = EnsembleModelBuilder(layers, {'num_models': 3}, device='cpu').build()
    fw = prepare_fused_weights(m.net)
    assert (fw.num_members, fw.in_dim, fw.out_dim, fw.num_layers) == (3, 7, 2, 4)
    assert [tuple(w.shape) for w in fw.ws] == \
        [(3, 7, 128)] + [(3, 128, 128)] * 3
    assert fw.w_all.numel() == 3 * 7 * 128 + 3 * 3 * 128 * 128
    assert tuple(fw.b_all.shape) == (4, 3, 128)
    assert fw.relu_flags.tolist() == [1, 1, 1, 0]
    assert fw.relu_flags.dtype == torch.int32
    assert fw.macs_per_row == 7 * 32 + 2 * 32 * 32 + 32 * 2
    # zero padding beyond the real widths, and views into the packed buffer
    assert float(fw.ws[1][:, 32:].abs().sum()) == 0.0
    assert float(fw.ws[1][:, :, 32:].abs().sum()) == 0.0
    assert fw.ws[1].data_ptr() == fw.w_all.data_ptr() + 3 * 7 * 128 * 4


@pytest.mark.parametrize('layers', [
    descr(in_dim=5, width=256, hidden=1),                    # width > 128
    descr(in_dim=5, width=32, hidden=1, out_dim=200),        # output > 128
    [{'Linear': {'args': [5, 16]}}, {'ReLU': {}}, {'Dropout': {'args': [0.2]}},
     {'Linear': {'args': [16, 1]}}],                         # dropout
])
def test_unfusable_networks_run_member_by_member(layers):
    jm = jax_ensemble(layers, members=3)
    pm = port_of(jm)
    assert prepare_fused_weights(pm.net) is None
    in_dim = layers[0]['Linear']['args'][0]
    x = np.random.default_rng(1).normal(size=(40, in_dim)).astype(np.float32)
    got = pm(x, return_ue=True)
    assert_ue_close(got, jm(x, return_ue=True))


@pytest.mark.parametrize('layers', [
    descr(in_dim=5, width=32, hidden=2),                     # flagship-like
    descr(in_dim=200, width=128, hidden=2),                  # input > 128
    descr(in_dim=300, width=8, hidden=0, out_dim=4),         # one wide Linear
    descr(in_dim=5, width=8, hidden=70, bn=False),           # 71 layers
    descr(in_dim=5, width=256, hidden=1),                    # width > 128
    descr(in_dim=5, width=32, hidden=1, out_dim=200),        # output > 128
    [{'Linear': {'args': [5, 16]}}, {'ReLU': {}}, {'Dropout': {'args': [0.2]}},
     {'Linear': {'args': [16, 1]}}],                         # dropout
])
def test_kernel_takes_the_networks_the_tpu_kernel_takes(layers):
    """The port folds a network for its kernel exactly when the JAX package
    folds it for ``_fused_kernel``, so no network the reference runs fused
    runs member by member on the card."""
    jm = jax_ensemble(layers, members=2)
    jax_fused = bool(jax_prepare_fused_weights(jm.net, jm.params,
                                               jm.state).folded)
    fw = prepare_fused_weights(port_of(jm).net)
    assert (fw is not None) == jax_fused
    if fw is not None:
        in_dim = layers[0]['Linear']['args'][0]
        x = np.random.default_rng(4).normal(size=(70, in_dim)).astype(np.float32)
        assert_ue_close(fused_forward_prefolded(fw, torch.from_numpy(x)),
                        jm(x, return_ue=True))


def test_fold_cache_follows_in_place_weight_updates():
    jm = jax_ensemble(descr(), members=3)
    pm = port_of(jm)
    x = np.random.default_rng(2).normal(size=(30, 5)).astype(np.float32)
    first = pm(x, return_ue=True)
    assert pm.fused_weights() is pm.fused_weights()    # cached
    jm2 = jax_ensemble(descr(), members=3, seed=11)
    pm.load_arrays(jm2.arrays_dict())                  # in-place copies
    second = pm(x, return_ue=True)
    assert not torch.allclose(first[0], second[0])
    assert_ue_close(second, jm2(x, return_ue=True))
    with torch.no_grad():
        pm.net.layers[1].running_var.mul_(2.0)          # BN state alone
    third = pm(x, return_ue=True)
    assert not torch.allclose(second[0], third[0])

