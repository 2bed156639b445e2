"""The bf16 forms of the port's kernels, through their plain versions on the
CPU, against the JAX package's TPU kernels run with
``compute_dtype=bfloat16`` in Pallas interpret mode on the same seeded
inputs and weights: kernel 1 (``_fused_kernel``), kernel 5
(``_anchored_kernel``, std and var, fewer anchors used than stored) and
the packed probe (``experiments/grid_r4/kernel_variants.py``, whose
``pl.pallas_call`` is rebuilt here around ``packed_kernel``). The JAX MC
kernel draws from the TPU's PRNG, which has no CPU lowering even in
interpret mode, so kernel 2's clean pass (p = 0) is held to JAX kernel 1's
bf16 function on the one-member fold: the same chain, rounded at the same
places.

Tolerances: TOL_MEAN and TOL_STD of tests/torch_parity.py, as in fp32 (the
two packages round at the same places; only the fp32 sums' order differs).
Where the order makes a hidden activation round to the other bf16 neighbour
(a flip), an output moves by far more than those bars (9e-5 and 4.6e-4 on
1 of 700 and 2 of 130 rows of two cases here); there the port is held to
be as exact as the JAX kernel instead: no farther from a float64
evaluation of the same bf16-rounded chain than twice the JAX kernel's
distance (as test_wide_corpus_kde_bundle_is_as_exact_as_jax does for
fp32 round-off). Each case also asserts that on its rows the JAX function's
bf16-vs-fp32 gap in the mean is at least GAP_FACTOR times TOL_MEAN's bar,
so it would fail on a port that stayed fp32, and that its std gap exceeds
TOL_STD's bar (a gap of 6.8-9.5 times that bar here: bf16 moves the spread
over members less than it moves their mean). The kernels themselves are
held to these plain versions on a card by tests/test_torch_cuda.py."""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnueehcs_tpu.ops import fused_anchored as jax_fa
from nnueehcs_tpu.ops import fused_ensemble as fe
from nnueehcs_tpu_torch.ops import ablate_forward as af
from nnueehcs_tpu_torch.ops import fused_anchored as fa
from nnueehcs_tpu_torch.ops import fused_mc_dropout as mc
from nnueehcs_tpu_torch.ops.fused_ensemble import fused_forward_prefolded

from torch_bf16 import assert_as_jax, assert_bf16_ue, assert_gap, chain64
from torch_parity import (TOL_MEAN, TOL_STD, descr, jax_anchored,
                          jax_ensemble, jax_mc_dropout, port_of)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_VARIANTS = os.path.join(REPO, 'experiments', 'grid_r4')
if _VARIANTS not in sys.path:
    sys.path.insert(0, _VARIANTS)
import kernel_variants  # noqa: E402

@pytest.fixture
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))


def _x(rows, in_dim=5, seed=0):
    return np.random.default_rng(seed).normal(size=(rows, in_dim)).astype(
        np.float32)


def _bf16(pm):
    return pm.set_precision('bf16-mixed')


@pytest.mark.parametrize('width,hidden,members,rows', [
    (16, 2, 3, 1), (32, 2, 4, 300), (64, 3, 3, 700), (128, 2, 2, 130)])
def test_kernel_1_bf16_matches_jax(width, hidden, members, rows):
    jm = jax_ensemble(descr(in_dim=5, width=width, hidden=hidden),
                      members=members, seed=width)
    x = _x(rows, seed=width)
    want32 = fe.fused_ensemble_eval(jm.net, jm.params, jm.state, x,
                                    layout='xt', interpret=True)
    jm.set_precision('bf16-mixed')
    want16 = fe.fused_ensemble_eval(jm.net, jm.params, jm.state, x,
                                    layout='xt', interpret=True)
    pm = _bf16(port_of(jm))
    fw = pm.fused_weights()
    assert fw.w_all.dtype == torch.bfloat16 and fw.b_all.dtype == torch.float32
    got = fused_forward_prefolded(fw, torch.from_numpy(x))
    ref64 = chain64(fw, x)
    if rows > 1:
        assert_bf16_ue(got, want16, want32, ref64)
    else:   # one row: the answers only, the gap is checked on more rows
        for g, w, r, tol in zip(got, want16, ref64, (TOL_MEAN, TOL_STD)):
            assert_as_jax(g, w, r, tol, 'one row')


def test_kernel_1_bf16_wide_input_matches_jax():
    """A 40-input network: x staged over two 32-column chunks."""
    jm = jax_ensemble(descr(in_dim=40, width=32, hidden=2), members=3, seed=1)
    x = _x(300, in_dim=40, seed=2)
    want32 = fe.fused_ensemble_eval(jm.net, jm.params, jm.state, x,
                                    layout='xt', interpret=True)
    jm.set_precision('bf16-mixed')
    want16 = fe.fused_ensemble_eval(jm.net, jm.params, jm.state, x,
                                    layout='xt', interpret=True)
    fw = _bf16(port_of(jm)).fused_weights()
    got = fused_forward_prefolded(fw, torch.from_numpy(x))
    assert_bf16_ue(got, want16, want32, chain64(fw, x))


@pytest.mark.parametrize('estimator,n_anchors,stored', [
    ('std', 7, 7), ('var', 7, 7), ('std', 4, 9), ('var', 3, 9)])
def test_kernel_5_bf16_matches_jax(interpret_pallas, estimator, n_anchors,
                                   stored):
    jm = jax_anchored(descr(in_dim=5, width=32, hidden=2),
                      num_anchors=n_anchors, stored=stored,
                      estimator=estimator)
    x = _x(300, seed=5)
    cache = jax_fa.prepare_fused_anchored(jm.net, jm.params, jm.state)
    want32 = jax_fa.fused_anchored_stats(cache, x, jm.anchors, n_anchors)
    jm.set_precision('bf16-mixed')
    cache = jax_fa.prepare_fused_anchored(jm.net, jm.params, jm.state)
    assert cache.compute_dtype == 'bfloat16'
    want16 = jax_fa.fused_anchored_stats(cache, x, jm.anchors, n_anchors)
    pm = _bf16(port_of(jm))
    aw = pm.anchored_weights()
    assert aw.w_all.dtype == torch.bfloat16 and aw.w0d.dtype == torch.float32
    got = fa.fused_anchored_stats(aw, torch.from_numpy(x), pm.anchors,
                                  n_anchors)
    v = fa.anchor_rows(aw, pm.anchors[:n_anchors])
    assert_bf16_ue(got, want16, want32, chain64(aw, x, v))
    # the model's spread (std or std^2) is the kernel's
    mean, spread = pm(x, return_ue=True)
    np.testing.assert_array_equal(mean.numpy(), got[0].numpy())
    want_spread = got[1] ** 2 if estimator == 'var' else got[1]
    np.testing.assert_array_equal(spread.numpy(), want_spread.numpy())


def _jax_one_member_kernel_1(folded, x, compute_dtype):
    """JAX kernel 1 (interpret mode) on a one-member fold, wide layout."""
    ws, bs, relus = fe._pad_folded(folded, 1, compute_dtype=compute_dtype)
    rows = x.shape[0]
    bpad, tile = fe._plan_rows(rows)
    x_pad = np.zeros((bpad, ws[0].shape[1]), np.float32)
    x_pad[:rows, :x.shape[1]] = x
    mean, _ = fe._fused_forward(
        jnp.asarray(x_pad), tuple(ws), tuple(bs), 1, tuple(relus),
        folded[-1][0].shape[-1], tile,
        compute_dtype=jnp.dtype(compute_dtype).name, layout='wide',
        interpret=True)
    return np.asarray(mean)[:rows]


@pytest.mark.parametrize('width,hidden,rows', [(32, 2, 300), (64, 3, 257)])
def test_kernel_2_bf16_clean_pass_matches_jax_kernel_1(width, hidden, rows):
    """p = 0: every pass is the clean pass, so the port's MC mean is its
    bf16 chain and its std exactly 0; the chain against JAX kernel 1's
    bf16 function on the same one-member fold."""
    jm = jax_mc_dropout(descr(in_dim=5, width=width, hidden=hidden),
                        num_samples=6, p=0.0, seed=width)
    folded, drops = fe.fold_mc_dropout_params(jm.net, jm.params, jm.state)
    assert any(layer.__class__.__name__ == 'Dropout' for layer in jm.net.layers)
    x = _x(rows, seed=3)
    want32 = _jax_one_member_kernel_1(folded, x, jnp.float32)
    want16 = _jax_one_member_kernel_1(folded, x, jnp.bfloat16)
    pm = _bf16(port_of(jm))
    mw = pm.mc_weights()
    assert mw.w_all.dtype == torch.bfloat16
    mean, std = mc.fused_mc_forward(mw, torch.from_numpy(x), 6, 99)
    assert_as_jax(mean, want16, chain64(mw, x)[0], TOL_MEAN, 'mean')
    assert_gap(want16, want32, TOL_MEAN, 'mean')
    assert float(std.abs().max()) == 0.0


def _jax_packed(x_pad, ws, bs, relus, out_dim, tile, compute_dtype):
    """kernel_variants.packed_forward's pallas_call, in interpret mode."""
    from jax.experimental import pallas as pl
    kernel = functools.partial(kernel_variants.packed_kernel,
                               num_members=ws[0].shape[0],
                               num_layers=len(ws), relus=relus,
                               out_dim=out_dim, compute_dtype=compute_dtype)
    bpad, dpad = x_pad.shape
    in_specs = [pl.BlockSpec((tile, dpad), lambda i: (i, 0))]
    in_specs += [pl.BlockSpec(w.shape, lambda i: (0, 0, 0)) for w in ws]
    in_specs += [pl.BlockSpec(b.shape, lambda i: (0, 0)) for b in bs]
    out = pl.pallas_call(
        kernel, grid=(bpad // tile,), in_specs=in_specs,
        out_specs=pl.BlockSpec((tile, 128), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((bpad, 128), jnp.float32),
        interpret=True)(x_pad, *ws, *bs)
    return out[:, :out_dim], out[:, out_dim:2 * out_dim]


@pytest.mark.parametrize('out_dim', [1, 3])
def test_packed_probe_bf16_matches_jax(out_dim):
    jm = jax_ensemble(descr(in_dim=5, width=32, hidden=2, out_dim=out_dim),
                      members=4, seed=3)
    folded = fe.fold_ensemble_params(jm.net, jm.params, jm.state)
    x = _x(256, seed=9)
    x_pad = np.zeros((256, 128), np.float32)
    x_pad[:, :5] = x
    want = {}
    for name, cdt in (('float32', jnp.float32), ('bfloat16', jnp.bfloat16)):
        ws, bs, relus = fe._pad_folded(folded, 4, compute_dtype=cdt)
        want[name] = _jax_packed(jnp.asarray(x_pad), tuple(ws), tuple(bs),
                                 tuple(relus), out_dim, 64, name)
    pm = _bf16(port_of(jm))
    fw = pm.fused_weights()
    got = af.packed_forward(fw, torch.from_numpy(x_pad))
    assert tuple(got[0].shape) == (256, out_dim)
    assert_bf16_ue(got, want['bfloat16'], want['float32'], chain64(fw, x))
    # the packed probe is kernel 1's bf16 function, bit for bit
    mean, std = fused_forward_prefolded(fw, torch.from_numpy(x))
    assert torch.equal(got[0], mean) and torch.equal(got[1], std)


def test_probes_without_a_bf16_form_refuse_bf16_weights():
    pm = _bf16(port_of(jax_ensemble(descr(in_dim=5, width=16, hidden=1),
                                    members=2)))
    fw = pm.fused_weights()
    x_pad = torch.zeros(64, 128)
    for call in (lambda: af.ablate_forward(fw, x_pad),
                 lambda: af.xt_forward(fw, x_pad[:, :8].T.contiguous()),
                 lambda: af.narrow_forward(fw, x_pad[:, :8].contiguous())):
        with pytest.raises(ValueError, match='float32'):
            call()


def test_wrappers_refuse_weights_of_a_dtype_without_a_kernel():
    pm = port_of(jax_ensemble(descr(in_dim=5, width=16, hidden=1), members=2))
    from nnueehcs_tpu_torch.ops.fused_ensemble import FusedWeights, \
        _fold_linear_chain
    folded, _ = _fold_linear_chain(pm.net)
    fw = FusedWeights(folded, torch.float16)
    with pytest.raises(ValueError, match='compute dtype'):
        fused_forward_prefolded(fw, torch.zeros(4, 5))
