"""The kernel-attribution entry point (``nnueehcs_tpu_torch.attrib``) on
the CPU, where it runs the probes' plain versions and their gates only:
every variant of both batteries is gated, each form of the probes' math
equals its control bit for bit (kernel 1, or the FFMA body's prod; kernel
3 for the training probe's prod), kernel 1 is held to its plain version,
and the command line prints one JSON line per gate. Its timing runs only
on a card (chip_smoke.py's attribution phase)."""
import json
import os
import subprocess
import sys

import pytest
import torch

from nnueehcs_tpu_torch import attrib
from nnueehcs_tpu_torch.ops import ablate_epoch as ae
from nnueehcs_tpu_torch.ops import fused_train as ft

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_forward_battery_gates_every_variant_on_the_cpu(capsys):
    out = attrib.forward_battery('cpu', seed=1, rows=200)
    assert out['variants'] == {}          # no device time on the CPU
    gates = out['gates']
    assert {'prod', 'io_floor', 'one_out', 'gemm_only', 'no_epi',
            'members=1', 'layers=5', 'xT input', 'xT+outT', 'narrow-in',
            'narrow-out', 'narrow-both', 'packed', 'kernel 1'} <= set(gates)
    for name in ('prod', 'one_out'):
        assert gates[name]['equals'] == 'kernel 1', name
    for name in ('xT input', 'xT+outT', 'narrow-both', 'packed'):
        assert gates[name]['equals'] == 'ffma prod', name
    for name in ('gemm_only', 'kernel 1'):
        assert gates[name]['equals'] is None, name
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert len(lines) == len(gates) + 1
    assert all(l['battery'] == 'forward' for l in lines)


def test_train_battery_gates_every_variant_on_the_cpu():
    """Every probe variant against its one-step launches bit for bit and
    against its plain version; gn_fused step by step on the flagship as
    built; kernel 3 step by step against the plain version at every batch
    of the batch scaling, and twice bit for bit; the probe's prod, and its
    graph replay, bit for bit with kernel 3 at every batch."""
    out = attrib.train_battery('cpu', seed=2, steps=8)
    gates = out['gates']
    binding = f'gn_fused clip={attrib.BINDING_CLIP:g}'
    batches = {f'kernel 3 B={b}' for b in attrib.BATCHES}
    timed = {'unroll2_vs_prod', 'unroll4_vs_prod', 'ch4096_vs_prod',
             'ch8_vs_prod', 'unroll4+gn+ch4096_vs_gn_fused'}
    repeats = {'kernel 3 repeat', 'prod repeat'}
    as_built = f'gn_fused as built clip={attrib.BINDING_CLIP:g}'
    assert set(gates) == set(attrib.TRAIN_VARIANTS) | {binding} | batches \
        | timed | repeats | {as_built}
    for name in repeats | timed:
        assert gates[name]['bit_for_bit'] and gates[name]['steps'] == 8
    for name in batches | {as_built}:
        assert gates[name]['stepwise']['steps'] == attrib.GATE_STEPS
        assert gates[name]['stepwise']['over_tol_outside_reach'] == 0
    for name in batches:
        assert gates[name]['probe_prod_bit_for_bit_with_kernel_3']
        assert gates[name]['stepwise']['loss_flips'] == 0
    assert [gates[f'kernel 3 B={b}']['resident']
            for b in attrib.BATCHES] == [True, False, False, False]
    for name in set(attrib.TRAIN_VARIANTS) | {binding}:
        errs = gates[name]['max_abs_err']
        assert set(errs) == set(attrib.TOL_TRAIN), name
        mode = attrib.TRAIN_VARIANTS.get(name, {}).get('mode', 'prod')
        # the whole launch bit for bit its one-step launches; an unrolled
        # run bit for bit the run without unroll; the steps are held to the
        # plain version
        assert gates[name]['bit_for_bit_with_one_step_launches'], name
        assert gates[name].get('bit_for_bit_with_unroll_1', False) == (
            'unroll' in attrib.TRAIN_VARIANTS.get(name, {})), name
        assert ('grad_norm' in gates[name]) == (mode in ('prod', 'no_opt'))
    # the ordinary gates' clip (5) does not bind; the binding gate's does,
    # on every step
    assert gates['gn_fused']['clip_binds_steps'] == 0
    assert gates[binding]['clip'] == attrib.BINDING_CLIP
    assert gates[binding]['clip_binds_steps'] == attrib.GATE_STEPS
    assert gates[binding]['grad_norm'][0] >= attrib.BINDING_CLIP


def test_train_battery_bf16_gates_kernel_3b_on_the_cpu():
    """The bf16 mode: kernel 3's bf16 form step by step against its plain
    version (the bf16 bars) at every batch, and twice bit for bit; no
    probe variant (the probe is fp32 only)."""
    out = attrib.train_battery('cpu', seed=2, steps=8, bf16=True)
    gates = out['gates']
    assert set(gates) == {f'kernel 3b B={b}' for b in attrib.BATCHES} | {
        'kernel 3b repeat'}
    for b in attrib.BATCHES:
        step = gates[f'kernel 3b B={b}']['stepwise']
        assert step['steps'] == attrib.GATE_STEPS
        assert step['losses']['gap_max'] > 0
    assert gates['kernel 3b repeat']['bit_for_bit']
    assert out['variants'] == {} and out['batch_scaling'] == {}


def test_train_work_counts_each_mode():
    _, plan, _, _, _ = attrib.train_problem(0, 'cpu', steps=8)
    flops = {mode: attrib._train_work(plan, 8, mode)[0]
             for mode in ('prod', 'no_opt', 'no_bwd', 'fwd1', 'empty')}
    assert flops['prod'] == flops['no_opt'] == attrib.train_flops(plan, 8)
    assert flops['no_bwd'] == plan.num_members * flops['fwd1'] > 0
    assert flops['empty'] == 0.0
    moved = {mode: attrib._train_work(plan, 8, mode)[1]
             for mode in ('prod', 'no_opt', 'empty')}
    assert moved['prod'] > moved['no_opt'] > moved['empty'] > 0


def test_command_line_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, '-m', 'nnueehcs_tpu_torch.attrib', 'forward',
         '--device', 'cpu', '--rows', '64', '--seed', '3'],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(l) for l in proc.stdout.splitlines()]
    assert lines[-1]['device'] == 'cpu' and lines[-1]['rows'] == 64
    assert sum('gate' in l for l in lines) == len(lines) - 1


def test_probe_prod_records_the_plain_versions_relu_decisions():
    """The probe's prod with ``signs`` (its plain version on the CPU)
    records the same ReLU decisions as kernel 3's plain version and
    computes the same step, so the step-by-step gate can hold it."""
    _, plan, bufs, xs, ys = attrib.train_problem(4, 'cpu', batch=16, steps=2,
                                                 separate=True)
    shape = (2, plan.num_members, plan.n_bn, plan.batch, ft.LANES)
    signs = [torch.zeros(shape, dtype=torch.uint8) for _ in range(2)]
    got = attrib.probe_prod(plan, *[b.clone() for b in bufs], xs, ys,
                            attrib.LR, 0, signs=signs[0])
    want = ft.fused_epoch_reference(plan, *[b.clone() for b in bufs], xs,
                                    ys, attrib.LR, 0, signs=signs[1])
    assert torch.equal(signs[0], signs[1]) and bool(signs[1].any())
    for (name, tol), a, b in zip(attrib.TOL_TRAIN.items(), got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=tol, msg=name)
    with pytest.raises(ValueError, match='signs'):
        ae.ablate_epoch(plan, *[b.clone() for b in bufs], xs, ys, attrib.LR,
                        0, mode='no_bwd', signs=signs[0])


def test_stepwise_gate_refuses_a_wrong_loss_gradient(monkeypatch):
    """A kernel whose l1 loss gradient has the wrong sign moves every
    member's output bias as a flipped loss decision would, on every step;
    the fp32 gate credits such flips on at most one step in
    LOSS_FLIP_STEPS, so it fails."""
    _, plan, bufs, xs, ys = attrib.train_problem(5, 'cpu', batch=16, steps=2,
                                                 separate=True)
    right = ft._loss_and_grad

    def wrong_sign(*args):
        term, grad = right(*args)
        return term, -grad

    def wrong(*args, signs=None):
        with monkeypatch.context() as patch:
            patch.setattr(ft, '_loss_and_grad', wrong_sign)
            return ft.fused_epoch_reference(*args, signs=signs)

    with pytest.raises(RuntimeError, match='loss decisions flipped on 2 of '
                                           '2 steps'):
        attrib.stepwise_vs_plain(plan, bufs, xs, ys, attrib.LR, 0, 0, None,
                                 epoch=wrong)
