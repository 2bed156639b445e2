"""Kernel 3b's bf16 checks as ``chip_smoke.py`` and
``tools/bf16_curve_seeds.py`` run them, here on the CPU where the kernel's
wrapper runs its plain version: the step-by-step check
(``attrib.stepwise_vs_plain_bf16``) gated or listing the bars passed, step
by step, and the loss-curve bars (``chip_smoke.bf16_curve_bars``), each
against a planted fault (member 0's learning rate doubled,
``bf16_curve_seeds.member_lr_fault``) that they must catch."""
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

import chip_smoke
from nnueehcs_tpu_torch import attrib
from nnueehcs_tpu_torch.ops import fused_train as ft

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
