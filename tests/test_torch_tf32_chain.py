"""The arithmetic of the fp32 kernels 1 (the ensemble), 2 (MC dropout) and
5 (anchored) on the card, emulated in plain torch (tests/torch_tf32.py: the
weights read back from the kernels' 3xTF32 image as the descriptors address
it, each product ``a_lo w_hi + a_hi w_lo + a_hi w_hi`` on TF32 parts
rounded by bit mask; kernels 2 and 5: a tile's passes in ``GROUPS`` groups
each shifted by its own first pass, the groups merged by Chan's formula in
group order; kernel 1: the members folded in member order, shifted by
member 0), held to the references the kernels answer to before any card
runs them: kernel 1's to the JAX package's ``_fused_kernel`` and kernel
5's to its ``_anchored_kernel`` (Pallas interpret mode, as
tests/test_fused_ensemble.py and tests/test_fused_anchored.py run them),
both also to the port's plain versions; kernel 2's to the port's plain
version on the same hash masks (the JAX kernel draws its masks from the
TPU's PRNG, which no CPU run reproduces), also with a seed table and a row
offset. Counts of samples or anchors: 1, 2, GROUPS - 1, GROUPS, 129 and
229; kernel 1: 1, 2, 3, 8, 9 and 28 members, 5 or 13 inputs, 1, 2 or 7
Linears, 1 or 9 outputs.

Tolerances: mean 1e-5 absolute and relative; std 1e-3 relative, 1e-5
absolute (tests/torch_parity.py's: the groups' one-pass sums and Chan's
merge against the JAX kernel's and the plain version's shifted sums; the
3xTF32 products carry about 2^-21 of each weight)."""
import functools

import numpy as np
import pytest
import torch

from nnueehcs_tpu.ops import fused_anchored as jax_fa
from nnueehcs_tpu.ops.fused_ensemble import fused_ensemble_eval
from nnueehcs_tpu_torch.model_builder import MCDropoutModelBuilder
from nnueehcs_tpu_torch.ops import fused_anchored as fa
from nnueehcs_tpu_torch.ops import fused_eval_chain as ec
from nnueehcs_tpu_torch.ops import fused_mc_dropout as mc
from nnueehcs_tpu_torch.ops.fused_ensemble import (fused_forward_plain,
                                                   prepare_fused_weights)

from torch_parity import (assert_ue_close, descr, jax_anchored, jax_ensemble,
                          member_outputs, port_of)
from torch_tf32 import (groups, merged_stats, mm3, tf32_anchored,
                        tf32_ensemble, tf32_mc)

COUNTS = (1, 2, ec.GROUPS - 1, ec.GROUPS, 129, 229)


@pytest.fixture
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))


def _x(rows, in_dim=5, seed=0):
    return np.random.default_rng(seed).normal(size=(rows, in_dim)).astype(
        np.float32)


def _mc_weights(in_dim=5, width=32, hidden=2, out_dim=2, p=0.2):
    m = MCDropoutModelBuilder(descr(in_dim=in_dim, width=width,
                                    hidden=hidden, out_dim=out_dim),
                              {'num_samples': 4, 'dropout_percent': p},
                              seed=5, device='cpu').build()
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for layer in m.net.layers:
            if hasattr(layer, 'running_var'):
                shape = layer.running_var.shape
                layer.running_mean.copy_(torch.randn(shape, generator=gen)
                                         * 0.3)
                layer.running_var.copy_(torch.rand(shape, generator=gen)
                                        + 0.5)
    return mc.prepare_mc_weights(m.net)


def test_groups_cover_the_passes_in_order():
    for count in (*COUNTS, 16, 128, 1000):
        bounds = groups(count)
        assert len(bounds) == ec.GROUPS
        assert [f for f, n in bounds if n] == sorted(
            f for f, n in bounds if n)
        covered = [i for f, n in bounds for i in range(f, f + n)]
        assert covered == list(range(count))
        sizes = [n for _, n in bounds]
        assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes,
                                                                reverse=True)


def test_merged_stats_is_the_mean_and_unbiased_std():
    gen = torch.Generator().manual_seed(3)
    for count in COUNTS:
        outs = [torch.randn((5, 3), generator=gen) * 0.1 + 1e3
                for _ in range(count)]
        mean, std = merged_stats(outs, count)
        stack = torch.stack(outs).double()
        np.testing.assert_allclose(mean.numpy(), stack.mean(0).numpy(),
                                   rtol=1e-6, atol=1e-5)
        want = stack.std(0, correction=1) if count > 1 else \
            torch.zeros_like(stack[0])
        np.testing.assert_allclose(std.numpy(), want.numpy(), rtol=1e-3,
                                   atol=1e-5)


def test_mm3_carries_fp32_products():
    gen = torch.Generator().manual_seed(4)
    a = torch.randn((64, 128), generator=gen)
    w = torch.randn((128, 128), generator=gen)
    hi = ec.tf32_round(w)
    lo = ec.tf32_round(w - hi)
    exact = a.double() @ w.double()
    one = ec.tf32_round(a) @ hi
    err3 = float((mm3(a, hi, lo).double() - exact).abs().max())
    err1 = float((one.double() - exact).abs().max())
    assert err3 < 1e-4 < err1          # one TF32 product keeps 3 digits


@pytest.mark.parametrize('count', COUNTS)
def test_tf32_anchored_matches_the_jax_kernel(interpret_pallas, count):
    jm = jax_anchored(descr(in_dim=5, width=32, hidden=2, out_dim=2),
                      num_anchors=count)
    pm = port_of(jm)
    x = _x(70, seed=count)
    cache = jax_fa.prepare_fused_anchored(jm.net, jm.params, jm.state)
    assert cache.folded
    ref = jax_fa.fused_anchored_stats(cache, x, jm.anchors, count)
    aw = fa.prepare_fused_anchored(pm.net)
    v = fa.anchor_rows(aw, torch.as_tensor(pm.anchors)[:count])
    got = tf32_anchored(aw, torch.from_numpy(x), v)
    if count == 1:
        assert float(got[1].abs().max()) == 0.0
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                                   rtol=1e-5, atol=1e-5)
    else:
        assert_ue_close(got, ref)
    assert_ue_close(got, fa.fused_anchored_plain(aw, torch.from_numpy(x), v))


@pytest.mark.parametrize('count', COUNTS)
def test_tf32_mc_matches_the_plain_version(count):
    mw = _mc_weights()
    x = torch.from_numpy(_x(70, seed=count))
    got = tf32_mc(mw, x, count, 1234567)
    want = mc.fused_mc_forward_plain(mw, x, count, 1234567)
    assert_ue_close(got, want)
    if count == 1:
        assert float(got[1].abs().max()) == 0.0


@pytest.mark.parametrize('count', [ec.GROUPS + 1, 37])
def test_tf32_mc_with_a_seed_table_and_a_row_offset(count):
    mw = _mc_weights(in_dim=7, width=64, hidden=3, out_dim=3, p=0.3)
    x = torch.from_numpy(_x(150, in_dim=7, seed=count))
    seeds = [(b * 7919 + 13) % 2**32 for b in range(10)]
    got = tf32_mc(mw, x, count, 0, 37, seeds, 20)
    want = mc.fused_mc_forward_plain(mw, x, count, 0, 37, seeds, 20)
    assert_ue_close(got, want)


def test_tf32_mc_one_linear_with_a_mask_on_x():
    gen = torch.Generator().manual_seed(4)
    w = torch.randn((1, 37, 9), generator=gen) / 37 ** 0.5
    b = torch.randn((1, 9), generator=gen) * 0.1
    mw = mc.McWeights([(w, b, False)], [0.1], [0], torch.float32)
    x = torch.from_numpy(_x(65, in_dim=37, seed=8))
    assert_ue_close(tf32_mc(mw, x, 11, 42),
                    mc.fused_mc_forward_plain(mw, x, 11, 42))


def test_tf32_anchored_far_from_the_data():
    """Inputs 40 past the data: outputs of large magnitude, where a
    misplaced TF32 part would show far beyond the bars."""
    jm = jax_anchored(descr(in_dim=5, width=32, hidden=2, out_dim=1),
                      num_anchors=17)
    aw = fa.prepare_fused_anchored(port_of(jm).net)
    x = torch.from_numpy(_x(66, seed=9) + 40.0)
    v = fa.anchor_rows(aw, torch.as_tensor(port_of(jm).anchors))
    assert_ue_close(tf32_anchored(aw, x, v),
                    fa.fused_anchored_plain(aw, x, v))


ENSEMBLE_MEMBERS = (1, 2, 3, 8, 9, 28)
# (in_dim, Linears, out_dim): every depth with both input widths and both
# output widths
ENSEMBLE_CHAINS = [(5, 1, 1), (13, 1, 9), (5, 2, 9), (13, 2, 1), (5, 7, 1),
                   (13, 7, 9)]


@pytest.mark.parametrize('members', ENSEMBLE_MEMBERS)
@pytest.mark.parametrize('in_dim,layers,out_dim', ENSEMBLE_CHAINS)
def test_tf32_ensemble_matches_the_jax_kernel(interpret_pallas, members,
                                              in_dim, layers, out_dim):
    """Kernel 1's 3xTF32 arithmetic against JAX's ``_fused_kernel`` in
    interpret mode (its members one by one where the chain is past the
    kernel's VMEM budget) and the port's plain version on the same seeded
    rows and the JAX model's weights."""
    jm = jax_ensemble(descr(in_dim=in_dim, width=32, hidden=layers - 1,
                            out_dim=out_dim), members=members)
    x = _x(70, in_dim=in_dim, seed=members + 10 * layers)
    fw = prepare_fused_weights(port_of(jm).net)
    assert (fw.num_members, fw.num_layers) == (members, layers)
    got = tf32_ensemble(fw, torch.from_numpy(x))
    ref = fused_ensemble_eval(jm.net, jm.params, jm.state, x, layout='xt',
                              interpret=True)
    if ref is None:
        # past the TPU kernel's VMEM budget (28 members of 7 Linears): the
        # JAX model runs its members one by one, which is then the reference
        assert members * layers > 100
        outs = member_outputs(jm, x).astype(np.float64)
        ref = outs.mean(0), outs.std(0, ddof=1)
    if members == 1:
        assert float(got[1].abs().max()) == 0.0
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                                   rtol=1e-5, atol=1e-5)
    else:
        assert_ue_close(got, ref)
    assert_ue_close(got, fused_forward_plain(fw, torch.from_numpy(x)))


def test_tf32_ensemble_far_from_the_data():
    """Inputs 40 past the data and a +1e3 bias on the last layer: outputs
    of large magnitude with a small spread, where a misplaced TF32 part or
    a fold that lost its shift would show far beyond the bars."""
    jm = jax_ensemble(descr(in_dim=5, width=32, hidden=2), members=8, seed=3)
    params = list(jm.params)
    params[-1] = dict(params[-1], b=params[-1]['b'] + 1e3)
    jm.params = tuple(params)
    jm.invalidate_cache()
    fw = prepare_fused_weights(port_of(jm).net)
    x = torch.from_numpy(_x(66, seed=9) + 40.0)
    mean, std = tf32_ensemble(fw, x)
    assert float(mean.abs().min()) > 900
    assert_ue_close((mean, std), fused_forward_plain(fw, x))
