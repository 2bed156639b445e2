"""The port's attribution probes of the fused ensemble pass
(``nnueehcs_tpu_torch/ops/ablate_forward.py``, their plain versions on the
CPU) against the TPU probes they replace, run in Pallas interpret mode on
the same seeded inputs and the same folded weights: ``ablate_forward`` and
``xt_forward`` (``experiments/grid_r5/attrib_eval.py``), ``narrow_forward``
(``experiments/grid_r5/attrib_eval2.py``) and ``packed_forward``
(``experiments/grid_r4/kernel_variants.py``, whose ``pl.pallas_call`` has
no interpret switch, so the test builds it around ``packed_kernel``).

Tolerances: means and raw member outputs 1e-5 absolute and relative; std
1e-3 relative plus 1e-5 absolute (the shifted one-pass variance, as
tests/test_torch_fused_ensemble.py); io_floor exact (it computes nothing).
The kernels themselves are held to these plain versions on a card by
tests/test_torch_cuda.py."""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnueehcs_tpu.ops import fused_ensemble as fe
from nnueehcs_tpu_torch.model_builder import EnsembleModelBuilder
from nnueehcs_tpu_torch.ops import ablate_forward as af
from nnueehcs_tpu_torch.ops.fused_ensemble import (fused_forward_plain,
                                                   prepare_fused_weights)

from torch_parity import TOL_MEAN, TOL_STD, descr, jax_ensemble, port_of

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for sub in ('grid_r5', 'grid_r4'):
    path = os.path.join(REPO, 'experiments', sub)
    if path not in sys.path:
        sys.path.insert(0, path)
import attrib_eval  # noqa: E402
import attrib_eval2  # noqa: E402
import kernel_variants  # noqa: E402

ROWS, TILE, D = 256, 64, 5


@pytest.fixture(scope='module')
def setup():
    jm = jax_ensemble(descr(in_dim=D, width=32, hidden=2), members=3)
    folded = fe.fold_ensemble_params(jm.net, jm.params, jm.state)
    ws, bs, relus = fe._pad_folded(folded, 3)
    fw = prepare_fused_weights(port_of(jm).net)
    x = np.random.default_rng(5).normal(size=(ROWS, D)).astype(np.float32)
    x_pad = np.zeros((ROWS, 128), np.float32)
    x_pad[:, :D] = x
    return {'ws': tuple(ws), 'bs': tuple(bs), 'relus': tuple(relus),
            'fw': fw, 'x': x, 'x_pad': x_pad}


def _assert_stats(got, want, std=True):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **TOL_MEAN)
    if len(got) > 1:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   **(TOL_STD if std else TOL_MEAN))


CASES = [(mode, n_out, None, None) for mode in af.MODES for n_out in (1, 2)]
CASES += [('prod', 2, 1, None), ('prod', 2, 2, None), ('prod', 2, None, 1),
          ('prod', 2, None, 2), ('no_epi', 2, 1, 2), ('gemm_only', 1, 2, 1)]


@pytest.mark.parametrize('mode,n_out,members,layers', CASES)
def test_ablate_forward_matches_the_jax_probe(setup, mode, n_out, members,
                                              layers):
    s = setup
    M = members or 3
    L = layers or 3
    want = attrib_eval.ablate_forward(
        jnp.asarray(s['x_pad']), s['ws'][:L], s['bs'][:L], M,
        s['relus'][:L], TILE, mode, n_out=n_out, interpret=True)
    got = af.ablate_forward(s['fw'], torch.from_numpy(s['x_pad']), members,
                            layers, TILE, mode, n_out)
    assert len(got) == n_out
    assert all(tuple(g.shape) == (ROWS, 128) for g in got)
    if mode == 'io_floor':
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        return
    _assert_stats(got, want, std=mode != 'no_epi')
    if M == 1 and mode != 'no_epi':
        assert n_out == 1 or float(got[1].abs().max()) == 0.0


@pytest.mark.parametrize('tile', [64, 128])
def test_io_floor_reads_the_first_row_of_each_tile(setup, tile):
    s = setup
    got = af.ablate_forward(s['fw'], torch.from_numpy(s['x_pad']),
                            tile=tile, mode='io_floor')
    want = attrib_eval.ablate_forward(
        jnp.asarray(s['x_pad']), s['ws'], s['bs'], 3, s['relus'], tile,
        'io_floor', interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    rows = np.arange(ROWS) // tile * tile
    np.testing.assert_array_equal(got[0].numpy()[:, 7],
                                  1.0 + s['x'][rows, 0])


def test_prod_is_the_production_plain_pass_bit_for_bit(setup):
    s = setup
    fw = s['fw']
    x = torch.from_numpy(s['x'])
    mean, std = fused_forward_plain(fw, x)
    for got in (af.ablate_forward(fw, torch.from_numpy(s['x_pad'])),
                af.narrow_forward(fw, torch.nn.functional.pad(x, (0, 3))),
                af.xt_forward(fw, torch.nn.functional.pad(x, (0, 3)).T
                              .contiguous()),
                af.packed_forward(fw, torch.from_numpy(s['x_pad']))):
        assert torch.equal(got[0][:, :fw.out_dim], mean)
        assert torch.equal(got[1][:, :fw.out_dim], std)
        if got[0].shape[1] > fw.out_dim:
            assert float(got[0][:, fw.out_dim:].abs().max()) == 0.0


@pytest.mark.parametrize('out_t', [False, True])
def test_xt_forward_matches_the_jax_probe(setup, out_t):
    s = setup
    x_t = np.zeros((8, ROWS), np.float32)
    x_t[:D] = s['x'].T
    want = attrib_eval.xt_forward(jnp.asarray(x_t), s['ws'], s['bs'], 3,
                                  s['relus'], TILE, out_t=out_t,
                                  interpret=True)
    got = af.xt_forward(s['fw'], torch.from_numpy(x_t), out_t=out_t)
    assert tuple(got[0].shape) == ((8, ROWS) if out_t else (ROWS, 128))
    _assert_stats(got, want)


@pytest.mark.parametrize('narrow_in', [True, False])
@pytest.mark.parametrize('narrow_out', [True, False])
def test_narrow_forward_matches_the_jax_probe(setup, narrow_in, narrow_out):
    s = setup
    x_in = s['x_pad'][:, :8].copy() if narrow_in else s['x_pad']
    want = attrib_eval2.narrow_forward(
        jnp.asarray(x_in), s['ws'], s['bs'], 3, s['relus'], TILE,
        narrow_in=narrow_in, narrow_out=narrow_out, interpret=True)
    got = af.narrow_forward(s['fw'], torch.from_numpy(x_in), narrow_in,
                            narrow_out)
    assert tuple(got[0].shape) == (ROWS, 8 if narrow_out else 128)
    _assert_stats(got, want)


def _jax_packed(x_pad, ws, bs, relus, out_dim, tile):
    """kernel_variants.packed_forward's pallas_call, in interpret mode."""
    from jax.experimental import pallas as pl
    kernel = functools.partial(kernel_variants.packed_kernel,
                               num_members=ws[0].shape[0],
                               num_layers=len(ws), relus=relus,
                               out_dim=out_dim)
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
def test_packed_forward_matches_the_jax_probe(out_dim):
    jm = jax_ensemble(descr(in_dim=D, width=32, hidden=2, out_dim=out_dim),
                      members=4, seed=3)
    folded = fe.fold_ensemble_params(jm.net, jm.params, jm.state)
    ws, bs, relus = fe._pad_folded(folded, 4)
    x = np.random.default_rng(9).normal(size=(ROWS, D)).astype(np.float32)
    x_pad = np.zeros((ROWS, 128), np.float32)
    x_pad[:, :D] = x
    want = _jax_packed(jnp.asarray(x_pad), tuple(ws), tuple(bs),
                       tuple(relus), out_dim, TILE)
    fw = prepare_fused_weights(port_of(jm).net)
    got = af.packed_forward(fw, torch.from_numpy(x_pad))
    assert tuple(got[0].shape) == (ROWS, out_dim)
    _assert_stats(got, want)


def test_cpu_tensors_run_the_plain_versions_without_a_launch(setup):
    s = setup
    fw, x_pad = s['fw'], torch.from_numpy(s['x_pad'])
    fns = (af.ablate_forward, af.xt_forward, af.narrow_forward,
           af.packed_forward)
    before = [fn.launches for fn in fns]
    assert torch.equal(af.ablate_forward(fw, x_pad, mode='no_epi')[0],
                       af.ablate_forward_plain(fw, x_pad, mode='no_epi')[0])
    af.xt_forward(fw, x_pad[:, :8].T.contiguous())
    af.narrow_forward(fw, x_pad[:, :8].contiguous())
    af.packed_forward(fw, x_pad)
    assert [fn.launches for fn in fns] == before


def test_wrappers_reject_what_the_kernel_does_not_take(setup):
    fw, x_pad = setup['fw'], torch.from_numpy(setup['x_pad'])
    with pytest.raises(TypeError, match='float32'):
        af.ablate_forward(fw, x_pad.double())
    with pytest.raises(ValueError, match='contiguous'):
        af.ablate_forward(fw, x_pad.T)
    with pytest.raises(ValueError, match='features'):
        af.ablate_forward(fw, x_pad[:, :3].contiguous())
    with pytest.raises(ValueError, match='mode'):
        af.ablate_forward(fw, x_pad, mode='fast')
    for members, layers in ((4, None), (0, None), (None, 0), (None, 4)):
        with pytest.raises(ValueError, match='members'):
            af.ablate_forward(fw, x_pad, num_members=members,
                              num_layers=layers)
    with pytest.raises(ValueError, match='narrow_in'):
        af.narrow_forward(fw, x_pad, narrow_in=True)
    wide = EnsembleModelBuilder(descr(out_dim=100), {'num_models': 2},
                                device='cpu').build()
    with pytest.raises(ValueError, match='do not fit'):
        af.packed_forward(prepare_fused_weights(wide.net), x_pad)
