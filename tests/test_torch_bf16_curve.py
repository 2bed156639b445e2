"""Kernel 3b's bf16 checks as ``chip_smoke.py``,
``tools/bf16_curve_seeds.py`` and ``tools/bf16_mc_stepwise.py`` run them,
here on the CPU where the kernel's wrapper runs its plain version: the
step-by-step check (``attrib.stepwise_vs_plain_bf16``) gated or listing
the bars passed, step by step, with the per-step bars or the witnessed
ones, and the loss-curve bars (``chip_smoke.bf16_curve_bars``), each
against planted faults that they must catch (member 0's learning rate
doubled, ``bf16_curve_seeds.member_lr_fault``; the learning rate or the
parameters moved on some steps, ``bf16_mc_stepwise.planted_fault``)."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from nnueehcs_tpu_torch import attrib
from nnueehcs_tpu_torch.ops import fused_train as ft
from torch_parity import one_torch_thread  # noqa: F401

# torch on one intra-op thread: the suite's xdist workers share the cores
pytestmark = pytest.mark.usefixtures('one_torch_thread')

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope='module')
def tool():
    spec = importlib.util.spec_from_file_location(
        'bf16_curve_seeds', REPO / 'tools' / 'bf16_curve_seeds.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module')
def problem():
    """The flagship's bf16 plan at batch 16, 3 steps, on the CPU."""
    _, plan, bufs, xs, ys = attrib.train_problem(5, 'cpu', batch=16, steps=3,
                                                 bf16=True)
    return plan, bufs, xs, ys


def curves(plan, bufs, xs, ys, epoch):
    return [run(p, *[b.clone() for b in bufs], xs, ys, 1e-3, 0, 0)[4]
            for run, p in ((epoch, plan), (ft.fused_epoch_reference, plan),
                           (ft.fused_epoch_reference,
                            dataclasses.replace(plan, bf16=False)))]


def test_stepwise_reports_every_step_and_passes_the_plain_kernel(problem):
    plan, bufs, xs, ys = problem
    records = []
    out = attrib.stepwise_vs_plain_bf16(plan, bufs, xs, ys, 1e-3, 0, 0, None,
                                        gate=False, on_step=records.append)
    assert [r['step'] for r in records] == [0, 1, 2]
    assert all(r['failed'] == [] for r in records)
    assert out['failures'] == [] and out['first_failed_step'] is None
    assert set(records[0]['rms_share']) == {'theta', 'm', 'v', 'sigma'}


def test_stepwise_catches_the_planted_fault(problem, tool):
    plan, bufs, xs, ys = problem
    fault = tool.member_lr_fault(ft, plan)
    out = attrib.stepwise_vs_plain_bf16(plan, bufs, xs, ys, 1e-3, 0, 0, None,
                                        gate=False, epoch=fault)
    assert out['first_failed_step'] == 0
    assert any('theta' in f for f in out['failures'])
    with pytest.raises(RuntimeError, match='step 0 theta'):
        attrib.stepwise_vs_plain_bf16(plan, bufs, xs, ys, 1e-3, 0, 0, None,
                                      epoch=fault)


def test_member_lr_fault_doubles_member_zeros_update_only(problem, tool):
    plan, bufs, xs, ys = problem
    fault = tool.member_lr_fault(ft, plan)
    got = fault(plan, *[b.clone() for b in bufs], xs[:1], ys[:1], 1e-3, 0, 0)
    plain = ft.fused_epoch_reference(plan, *[b.clone() for b in bufs],
                                     xs[:1], ys[:1], 1e-3, 0, 0)
    fast = ft.fused_epoch_reference(plan, *[b.clone() for b in bufs],
                                    xs[:1], ys[:1], 2e-3, 0, 0)
    rows = plan.slab_rows
    assert torch.equal(got[0][:rows], fast[0][:rows])
    assert torch.equal(got[0][rows:], plain[0][rows:])
    for j in (1, 2, 3, 4):
        assert torch.equal(got[j], plain[j])


def test_curve_bars_pass_the_plain_kernel_and_fail_the_fault(problem, tool):
    plan, bufs, xs, ys = problem
    host = ft.fused_epoch_reference(plan, *[b.clone() for b in bufs], xs, ys,
                                    1e-3, 0, 0)[4]
    same = chip_smoke.bf16_curve_bars(*curves(plan, bufs, xs, ys,
                                              ft.fused_epoch), host + 1e-6)
    assert same['gap_bar'] and same['witness_bar']
    assert same['max_abs_diff'] == 0.0
    faulty = chip_smoke.bf16_curve_bars(
        *curves(plan, bufs, xs, ys, tool.member_lr_fault(ft, plan)),
        host + 1e-6)
    assert not faulty['gap_bar'] and not faulty['witness_bar']


@pytest.mark.parametrize('apart,witness,gap_bar,witness_bar', [
    (1.0, 1.0, True, True),     # within the gap and the witness
    (3.0, 2.0, False, True),    # past the gap, within twice the witness
    (1.0, 0.4, True, False),    # within the gap, past twice the witness
    (5.0, 2.0, False, False),
])
def test_curve_bars_arithmetic(apart, witness, gap_bar, witness_bar):
    plain = torch.zeros(4)
    fp32 = torch.tensor([0.0, 2.0, 0.0, 0.0])          # the gap's max: 2
    kernel = torch.tensor([0.0, 0.0, apart, 0.0])
    host = torch.tensor([witness, 0.0, 0.0, 0.0])
    out = chip_smoke.bf16_curve_bars(kernel, plain, fp32, host)
    assert (out['gap_bar'], out['witness_bar']) == (gap_bar, witness_bar)
    assert out['witness_max'] == pytest.approx(witness)


def test_bf16_verdict_names_the_bar():
    res = {'rms_err': 1.0, 'bar_rms': 2.0, 'max_abs_err': 3.0,
           'bar_max': 4.0, 'gap_rms': 0.5, 'gap_max': 4.0}
    assert attrib.bf16_verdict('x', res) is None
    assert 'max 5.000e+00' in attrib.bf16_verdict(
        'x', dict(res, max_abs_err=5.0))


@pytest.fixture(scope='module')
def separate_mc():
    """The MC-dropout flagship with BatchNorm shifted off 0
    (``separate_relu``, the networks of ``tools/bf16_mc_stepwise.py``), its
    bf16 plan at batch 16, 3 steps, on the CPU."""
    before = chip_smoke.DEVICE
    chip_smoke.DEVICE = 'cpu'
    try:
        model = attrib.separate_relu(chip_smoke.build_mc(0),
                                     torch.Generator().manual_seed(7))
        plan = chip_smoke.train_plan(model, bf16=True, batch=16)
        bufs, xs, ys = chip_smoke.train_inputs(
            model, plan, np.random.default_rng(0), 3)
    finally:
        chip_smoke.DEVICE = before
    assert plan.n_drop == 5
    return plan, bufs, xs, ys, ft.drop_rates(model.net)


@pytest.fixture(scope='module')
def mc_tool():
    spec = importlib.util.spec_from_file_location(
        'bf16_mc_stepwise', REPO / 'tools' / 'bf16_mc_stepwise.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_per_step_bars_hold_each_step(problem, mc_tool):
    """Without ``witnessed`` each step is held to the gap's bars alone: one
    step of three with theta's change off by 0.3 of its gap fails there."""
    plan, bufs, xs, ys = problem
    out = attrib.stepwise_vs_plain_bf16(
        plan, bufs, xs, ys, 1e-3, 0, 0, None, gate=False,
        epoch=mc_tool.planted_fault(ft, gap_share=0.3, steps=(1,)))
    assert out['first_failed_step'] == 1
    assert all('step 1 theta' in f for f in out['failures'])
    assert not out['excursions']['witnessed']


@pytest.mark.parametrize('share,steps,fails', [
    (0.3, (0,), None),          # one excursion of three: within the count
    (0.3, (0, 1, 2), 'count'),  # an excursion on every step
    (3.0, (1,), 'reach'),       # one step past twice the gap
], ids=['one_step', 'every_step', 'one_step_far'])
def test_witnessed_bars_count_and_cap_the_excursions(separate_mc, mc_tool,
                                                     share, steps, fails):
    """With ``witnessed``, a step past the gap's bars and past twice the
    witnesses' shares on that step is an excursion: each must stay within
    twice the gap (or the witnesses), and there may be at most twice as
    many as the steps a witness spends past the gap's bars (at least 2).
    Here the host's plain step is the plain step itself and the tensor
    cores' stand-in sums exactly, so the witnesses stay within the bars."""
    plan, bufs, xs, ys, drops = separate_mc
    records = []
    out = attrib.stepwise_vs_plain_bf16(
        plan, bufs, xs, ys, 1e-3, 0, 11, drops, gate=False,
        on_step=records.append, witnessed=True,
        epoch=mc_tool.planted_fault(ft, gap_share=share, steps=steps))
    exc = out['excursions']
    assert exc['witness_steps_over'] == {'host': 0, 'witness': 0}
    assert exc['allowed'] == attrib.BF16_WITNESS_SHARE
    for r in records:
        assert r['host_rms_share']['theta'] == 0.0
        assert r['excursion'] == (r['step'] in steps)
        if r['step'] in steps:
            assert r['rms_share']['theta'] == pytest.approx(share, rel=0.05)
    assert exc['steps'] == len(steps)
    if fails is None:
        assert out['failures'] == []
    elif fails == 'count':
        assert len(out['failures']) == 1
        assert '3 excursions past the per-step bars' in out['failures'][0]
    else:
        assert out['first_failed_step'] == steps[0]
        assert all('excursion\'s bar' in f for f in out['failures'])


@pytest.mark.parametrize('plant', ['lr', 'lr_step', 'gap'])
def test_separate_relu_mc_dropout_holds_and_the_planted_fault_fails(
        separate_mc, mc_tool, plant):
    """On the MC-dropout flagship with BatchNorm shifted off 0 (where two
    correct bf16 versions part by up to the gap on single steps), the plain
    epoch holds every witnessed bar; each of the tool's planted faults
    fails them: the learning rate doubled on every step or on one step
    past an excursion's bar by more than 10x, half the gap on every step
    by the count."""
    plan, bufs, xs, ys, drops = separate_mc
    out = attrib.stepwise_vs_plain_bf16(plan, bufs, xs, ys, 1e-3, 0, 11,
                                        drops, witnessed=True)
    assert out['failures'] == []
    lr_scale, gap_share, steps = mc_tool.PLANTS[plant]
    if steps is not None:
        steps = (1,)            # the fixture has 3 steps
    records = []
    fault = attrib.stepwise_vs_plain_bf16(
        plan, bufs, xs, ys, 1e-3, 0, 11, drops, gate=False, witnessed=True,
        on_step=records.append,
        epoch=mc_tool.planted_fault(ft, lr_scale, gap_share, steps))
    assert fault['failures']
    if plant == 'gap':
        assert fault['excursions']['steps'] == 3
        assert 'excursions past the per-step bars' in fault['failures'][-1]
        return
    first = 0 if steps is None else steps[0]
    assert fault['first_failed_step'] == first
    assert records[first]['rms_share']['theta'] > 10 * 2 * max(
        1.0, records[first]['witness_rms_share']['theta'])


def test_a_flipped_l1_decision_frees_its_step(separate_mc):
    """An l1 decision taken the other way (here: step 1's closest row's
    target moved across its prediction) is read from the unclipped step
    as well as the clipped one, frees that step's theta, m and v from the
    bars, and counts as the run's one step with loss flips."""
    plan, bufs, xs, ys, drops = separate_mc
    assert plan.clip is not None and plan.loss == 'l1_loss'

    def flip_one_row(plan, theta, m, v, sigma, xs, ys, lr, step0, seed=0,
                     drops=None, signs=None):
        if step0 == 1:
            pred = ft._forward(plan, ft._constants(plan), theta.clone(),
                               sigma.clone(), xs[0], 0, 0, seed,
                               ft._drop_tensor(plan, drops, xs.device),
                               ft._saved(plan))[:, 0]
            diff = pred - ys[0][:, 0]
            r = int(diff.abs().argmin())
            ys = ys.clone()
            ys[0, r, 0] = pred[r] + diff[r].sign() * 1e-3
        return ft.fused_epoch(plan, theta, m, v, sigma, xs, ys, lr, step0,
                              seed, drops, signs=signs)
    records = []
    out = attrib.stepwise_vs_plain_bf16(
        plan, bufs, xs, ys, 1e-3, 0, 11, drops, gate=False, witnessed=True,
        on_step=records.append, epoch=flip_one_row)
    assert [r['loss_flips'] for r in records] == [0, 1, 0]
    assert out['steps_with_loss_flips'] == 1
    assert set(records[1]['rms_share']) == {'sigma'}
    assert not any('step 1 ' in f for f in out['failures'])
