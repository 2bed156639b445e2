"""Shared checks of the tests that hold the port's bf16 forms against the
JAX package's (tests/test_torch_bf16_*.py): the bf16-vs-fp32 gap a case
must show, the comparison that falls back, past a bf16 rounding flip, to
each package's distance from a float64 evaluation of the same bf16-rounded
chain, that evaluation, and the bar of a module walk (``assert_walk``)."""
import numpy as np
import torch

from torch_parity import TOL_MEAN, TOL_STD

GAP_FACTOR = 10
GAP_SHARE = 0.25


def assert_gap(bf16, fp32, tol, name, factor=GAP_FACTOR):
    """Somewhere on these rows the JAX function's bf16 answer is at least
    ``factor`` times ``tol``'s bar from its fp32 answer."""
    bf16, fp32 = (np.asarray(t, np.float64) for t in (bf16, fp32))
    ratio = np.max(np.abs(bf16 - fp32) / (tol['atol'] + tol['rtol']
                                          * np.abs(fp32)))
    assert ratio >= factor, (name, ratio)


def assert_as_jax(got, want, ref64, tol, name):
    """``got`` within ``tol`` of the JAX answer ``want``; where a bf16
    flip puts them apart, ``got`` no farther from the float64 chain
    ``ref64`` than twice the JAX answer is."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if np.allclose(got, want, **tol):
        return
    port_err = np.abs(got - ref64).max()
    jax_err = np.abs(want - ref64).max()
    assert port_err <= 2 * jax_err, (name, port_err, jax_err)


def assert_bf16_ue(got, want16, want32, ref64):
    """``got`` (mean, std) against the JAX bf16 answer (``assert_as_jax``,
    TOL_MEAN and TOL_STD), and the JAX answer's gap to its fp32 one at
    least GAP_FACTOR times TOL_MEAN's bar in the mean and past TOL_STD's
    bar in the std."""
    for g, w16, w32, r64, tol, name, factor in zip(
            got, want16, want32, ref64, (TOL_MEAN, TOL_STD), ('mean', 'std'),
            (GAP_FACTOR, 1)):
        assert_as_jax(g, w16, r64, tol, name)
        assert_gap(w16, w32, tol, name, factor)


def chain64(fw, x, v=None):
    """Mean and std of the port's bf16 chain evaluated in float64: x and
    each hidden activation rounded to bf16 where the kernel rounds them,
    the dots, biases and statistics in float64; over the members, or with
    ``v`` (the anchors' ``(k, 128)`` layer-0 rows) over the anchors of an
    anchored network."""
    def rnd(h):
        return h.float().to(torch.bfloat16).double()

    def layers(h, m, first):
        for l in range(first, fw.num_layers):
            w, b = fw.ws[l][m].double(), fw.b_all[l, m].double()
            if l == fw.num_layers - 1:
                h = h @ w[:, :fw.out_dim] + b[:fw.out_dim]
            else:
                h = h @ w + b
            if fw.relus[l]:
                h = torch.relu(h)
            if l != fw.num_layers - 1:
                h = rnd(h)
        return h

    xb = rnd(torch.from_numpy(np.asarray(x)))
    if v is None:
        outs = [layers(xb, m, 0) for m in range(fw.num_members)]
    else:
        u = xb @ fw.ws[0][0].double() + fw.b_all[0, 0].double()
        outs = []
        for j in range(v.shape[0]):
            h = u + v[j].double()
            if fw.relus[0]:
                h = torch.relu(h)
            outs.append(layers(rnd(h), 0, 1))
    o = torch.stack(outs)
    return o.mean(0).numpy(), o.std(0, correction=1).numpy()


def assert_walk(got, want16, want32, name):
    """The port's walk ``got`` against JAX's bf16 walk ``want16``: the
    difference's root mean square at most GAP_SHARE of JAX's bf16-vs-fp32
    gap's (to ``want32``), its largest element at most one bf16 unit at the
    largest magnitude of ``want16``; and the output fp32."""
    assert got.dtype == torch.float32, name
    got, want16, want32 = (np.asarray(t, np.float64)
                           for t in (got, want16, want32))
    err = got - want16
    gap = want16 - want32
    rms_err, rms_gap = np.sqrt(np.mean(err ** 2)), np.sqrt(np.mean(gap ** 2))
    assert rms_gap > 0, name
    assert rms_err <= GAP_SHARE * rms_gap, (name, rms_err, rms_gap)
    unit = 2.0 ** -7 * np.abs(want16).max()
    assert np.abs(err).max() <= unit, (name, np.abs(err).max(), unit)
