"""The port's plain bf16-mixed training epoch (``fused_epoch_reference``
under ``plan_fused_train(..., bf16=True)``) against the JAX package's
``_epoch_kernel`` in its bf16 form (``FusedTrainPlan.bf16``, run in
interpret mode on the CPU), on the four cases of the fp32 file: the
joint-mean l1 ensemble, the per-member mse ensemble, the MVE NLL and MC
dropout as a single net.

Bar (``attrib.bf16_close``, the principle the bf16 serving forms are held
to): two correct bf16 functions round the same operands, but a dot summed
in another order can round a later operand to the other bf16 neighbour. So
on the same outputs the port's error against JAX's bf16 result must have a
root mean square within 0.2 of JAX's own bf16-vs-fp32 gap's, and a largest
element within the gap's largest. It holds the per-step losses and the
BatchNorm running statistics of an epoch, the first moment ``m`` (the
scaled gradient) after one step from the same state, and the first 10
steps of a 20-step loss curve (the whole curve within the gap's max).
Theta after that step is held to
``tests/test_fused_train.py``'s 2e-2 for parameters (from a gradient at
rounding level, a BatchNorm-cancelled Linear bias, Adam moves a parameter
by up to lr either way), and the change it made in the step to the bf16
bars (from Adam moments that are not zero, the change follows m).

The card's step-by-step gate (``attrib.stepwise_vs_plain_bf16``) runs here
with the wrapper's plain version on both sides, and must refuse a form
that skipped the rounding, one whose v takes another b2, and one that
moved theta half as far."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnueehcs_tpu.ops import fused_train as ft
from nnueehcs_tpu_torch import attrib
from nnueehcs_tpu_torch.attrib import bf16_close
from nnueehcs_tpu_torch.ops import fused_train as pt

from test_torch_fused_train import (B, _batches, _jax_model, _moments,
                                    _torch)
from torch_parity import port_of

TOL_THETA = {'rtol': 0, 'atol': 2e-2}
LR, STEP0, SEED = 1e-3, 4, 20250
CURVE_STEPS, CURVE_CHECKED = 20, 10

CASES = {
    # name: (kind, loss, per_member, weight decay, dropout rate, members)
    'joint_l1_clip': ('ensemble', 'l1_loss', False, 0.0, None, 3),
    'per_member_mse_wd': ('ensemble', 'mse_loss', True, 0.01, None, 2),
    'mve_nll': ('mve', 'gaussian_nll', False, 0.0, None, 1),
    'mc_dropout_p02': ('mc', 'l1_loss', False, 0.0, 0.2, 1),
}


def _setup(case):
    """The JAX model's fp32 and bf16 plans, the port's bf16 plan, and the
    packed starting buffers (JAX arrays)."""
    kind, loss, per_member, wd, p, members = CASES[case]
    m = _jax_model(kind, loss, per_member, p or 0.2, members)
    kw = dict(loss=loss, per_member=per_member, clip=5.0, weight_decay=wd,
              member_stacked=kind == 'ensemble')
    plan32 = ft.plan_fused_train(m.net, members, B, **kw)
    plan16 = ft.plan_fused_train(m.net, members, B, bf16=True, **kw)
    pplan = pt.plan_fused_train(port_of(m).net, members, B, bf16=True, **kw)
    assert plan16.bf16 and pplan.bf16 and not plan32.bf16
    bufs = (ft.pack_tree(plan16, m.params), *_moments(plan16, m.params, 3),
            ft.pack_state(plan16, m.state))
    return m, plan32, plan16, pplan, bufs


def _run(m, plan32, plan16, pplan, bufs, steps, seed=0):
    """The same epoch through JAX's fp32 and bf16 kernels and the port's
    plain bf16 epoch: three (theta, m, v, sigma, losses) as numpy."""
    xs, ys = _batches(plan16, seed=seed, steps=steps)
    drops = ft.drop_rates(m.net)
    outs = []
    for plan in (plan32, plan16):
        out = ft.fused_epoch(plan, *[jnp.array(b) for b in bufs], xs, ys, LR,
                             STEP0, seed=SEED, drops=drops, interpret=True)
        outs.append([np.asarray(a) for a in out])
    got = pt.fused_epoch(pplan, *_torch(*bufs, xs, ys), LR, STEP0, seed=SEED,
                         drops=pt.drop_rates(port_of(m).net))
    outs.append([a.numpy() for a in got])
    return outs


def _hold(name, port, jax16, jax32):
    return bf16_close(name, torch.from_numpy(port), torch.from_numpy(jax16),
                      torch.from_numpy(jax32))


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_bf16_epoch_matches_jax_kernel(case):
    """A 6-step epoch: per-step losses and running statistics within the
    bf16 bars, and the epoch really is bf16 (its gap to fp32 is far beyond
    fp32 round-off)."""
    m, plan32, plan16, pplan, bufs = _setup(case)
    j32, j16, got = _run(m, plan32, plan16, pplan, bufs, 6)
    out = _hold(f'{case} losses', got[4], j16[4], j32[4])
    assert out['gap_max'] > 1e-5
    _hold(f'{case} sigma', got[3], j16[3], j32[3])
    np.testing.assert_allclose(got[0], j16[0], err_msg='theta', **TOL_THETA)


@pytest.mark.parametrize('case', sorted(CASES))
def test_one_bf16_step_moments_match_jax_kernel(case):
    """One step from the same state: ``m`` (0.9 m + 0.1 of the clipped
    gradient) and ``v`` within the bf16 bars, theta within 2e-2."""
    m, plan32, plan16, pplan, bufs = _setup(case)
    j32, j16, got = _run(m, plan32, plan16, pplan, bufs, 1, seed=5)
    _hold(f'{case} m', got[1], j16[1], j32[1])
    _hold(f'{case} v', got[2], j16[2], j32[2])
    _hold(f'{case} loss', got[4], j16[4], j32[4])
    np.testing.assert_allclose(got[0], j16[0], err_msg='theta', **TOL_THETA)
    theta0 = np.asarray(bufs[0])
    _hold(f'{case} theta change', *(out[0] - theta0 for out in (got, j16, j32)))


@pytest.mark.parametrize('case', ['joint_l1_clip', 'mc_dropout_p02'])
def test_bf16_loss_curve_matches_jax_kernel(case):
    """A 20-step epoch: the port's loss curve against JAX's bf16 one. A
    rounding flip at one step moves every later step of the trajectory
    (measured on the MC-dropout case: fp32 round-off, 1e-7, up to step 15,
    one flip of 9.3e-5 at step 6, then 1e-4 to 7e-4 from step 15), so the
    first CURVE_CHECKED steps are held to both bf16 bars and the whole
    curve to the gap's max: no step strays farther from JAX's bf16 curve
    than the farthest step of JAX's own bf16 curve from its fp32 one."""
    m, plan32, plan16, pplan, bufs = _setup(case)
    j32, j16, got = _run(m, plan32, plan16, pplan, bufs, CURVE_STEPS, seed=7)
    assert got[4].shape == (CURVE_STEPS,)
    n = CURVE_CHECKED
    _hold(f'{case} loss curve, first {n}', got[4][:n], j16[4][:n], j32[4][:n])
    err = np.abs(got[4] - j16[4])
    gap = np.abs(j16[4] - j32[4])
    assert err.max() <= gap.max(), (err, gap)


def test_bf16_plan_matches_jax_and_keeps_the_layout():
    """``bf16`` is the only field a bf16 plan changes, in both packages; the
    flat buffers stay fp32 and the bf16-buffer refusal stays."""
    m = _jax_model('ensemble', members=2)
    net = port_of(m).net
    for bf16 in (False, True):
        want = ft.plan_fused_train(m.net, 2, B, clip=5.0, bf16=bf16)
        got = pt.plan_fused_train(net, 2, B, clip=5.0, bf16=bf16)
        assert got.bf16 == want.bf16 == bf16
    p32 = pt.plan_fused_train(net, 2, B, clip=5.0)
    p16 = pt.plan_fused_train(net, 2, B, clip=5.0, bf16=True)
    assert {f: getattr(p16, f) for f in vars(p16) if f != 'bf16'} == \
        {f: getattr(p32, f) for f in vars(p32) if f != 'bf16'}
    theta = torch.zeros(p16.total_rows, pt.LANES)
    sigma = torch.zeros(p16.total_sig_rows, pt.LANES)
    xs = torch.zeros(1, B, p16.in_pad)
    ys = torch.zeros(1, B, p16.out_pad)
    with pytest.raises(NotImplementedError, match='fp32'):
        pt.fused_epoch(p16, theta.bfloat16(), theta, theta, sigma, xs, ys,
                       LR, 0)
    before = (pt.fused_epoch.launches, pt.fused_epoch.launches_bf16)
    out = pt.fused_epoch(p16, theta, theta.clone(), theta.clone() + 1e-4,
                         sigma, xs, ys, LR, 0)
    assert out[0].dtype == torch.float32
    assert (pt.fused_epoch.launches, pt.fused_epoch.launches_bf16) == before


def test_plain_bf16_epoch_rounds_where_jax_rounds():
    """The plain bf16 epoch's products round both operands: on operands
    exact in bf16 a product equals the fp32 one, on others it does not, and
    the bf16 and fp32 epochs from the same buffers part."""
    m, plan32, plan16, pplan, bufs = _setup('joint_l1_clip')
    pplan32 = pt.plan_fused_train(port_of(m).net, 3, B, clip=5.0)
    xs, ys = _torch(*_batches(plan16, steps=2))
    a = pt.fused_epoch(pplan, *_torch(*bufs), xs, ys, LR, STEP0)
    b = pt.fused_epoch(pplan32, *_torch(*bufs), xs, ys, LR, STEP0)
    assert float((a[4] - b[4]).abs().max()) > 1e-6
    # (x, W) in bf16 already: the first forward product is exact in both
    x16 = xs[:1].bfloat16().float()
    th = _torch(bufs[0])[0]
    W = th[pplan.lins[0].w_off:pplan.lins[0].w_off + pplan.lins[0].in_rows]
    W16 = W.bfloat16().float()
    assert torch.equal(pt._mm(pplan, x16[0], W16), x16[0] @ W16)
    assert not torch.equal(pt._mm(pplan, xs[0], W), xs[0] @ W)


def _unrounded(plan, theta, m, v, sigma, *args, **kw):
    return pt.fused_epoch_reference(dataclasses.replace(plan, bf16=False),
                                    theta, m, v, sigma, *args, **kw)


def _other_b2(plan, theta, m, v, sigma, *args, **kw):
    v0 = v.clone()
    out = pt.fused_epoch_reference(plan, theta, m, v, sigma, *args, **kw)
    v.copy_(v + 1e-4 * (v - v0))          # b2 a little off
    return out


def _half_step(plan, theta, m, v, sigma, *args, **kw):
    theta0 = theta.clone()
    out = pt.fused_epoch_reference(plan, theta, m, v, sigma, *args, **kw)
    theta.copy_(theta0 + 0.5 * (theta - theta0))
    return out


@pytest.mark.parametrize('form,refusal', [
    (None, None), (_unrounded, 'rms'), (_other_b2, 'v:'),
    (_half_step, 'theta')])
def test_stepwise_bf16_gate_holds_the_plain_epoch_and_refuses_wrong_forms(
        monkeypatch, form, refusal):
    m, plan32, plan16, pplan, bufs = _setup('joint_l1_clip')
    xs, ys = _torch(*_batches(plan16, steps=3))
    drops = pt.drop_rates(port_of(m).net)
    if form is None:
        out = attrib.stepwise_vs_plain(pplan, _torch(*bufs), xs, ys, LR,
                                       STEP0, SEED, drops)
        assert out['steps'] == 3 and out['flips'] == 0
        assert all(e == 0.0 for e in out['max_abs_err'].values())
        assert out['losses']['gap_max'] > 0
        return
    monkeypatch.setattr(pt, 'fused_epoch', form)
    with pytest.raises(RuntimeError, match=refusal):
        attrib.stepwise_vs_plain(pplan, _torch(*bufs), xs, ys, LR, STEP0,
                                 SEED, drops)


def test_loss_flips_show_in_the_output_bias():
    """``attrib.loss_flips``: one l1 sign decision taken the other way moves
    a member's output-bias gradient by 2c (c = 1 / (members x loss
    divisor), the joint mean's loss gradient of a row), which m carries
    scaled by 1 - b1; round-off does not count, nor does a smooth loss."""
    m, plan32, plan16, pplan, bufs = _setup('joint_l1_clip')
    xs, ys = _torch(*_batches(plan16, steps=1))
    state = _torch(*bufs)
    want = pt.fused_epoch_reference(pplan, *[b.clone() for b in state], xs,
                                    ys, LR, STEP0)
    k = pt._constants(pplan)
    row = pplan.slab_rows + pplan.lins[-1].b_off          # member 1
    jump = k['one_minus_b1'] * 2 * k['inv_members'] / k['loss_div']
    for shift, flipped in ((jump, [False, True, False]),
                           (1e-7 * float(want[1][row, 0].abs()),
                            [False] * 3)):
        got_m = want[1].clone()
        got_m[row, 0] += shift
        assert attrib.loss_flips(pplan, state[1], got_m,
                                 want[1]).tolist() == flipped
    mse = dataclasses.replace(pplan, loss='mse_loss')
    assert not attrib.loss_flips(mse, state[1], got_m + jump, want[1]).any()
