"""The kernel-attribution entry point (``nnueehcs_tpu_torch.attrib``) on
the CPU, where it runs the probes' plain versions and their gates only:
every variant of both batteries is gated, each form of the production
math equals kernels 1 and 3's plain versions bit for bit, and the
command line prints one JSON line per gate. Its timing runs only on a
card (chip_smoke.py's attribution phase)."""
import json
import os
import subprocess
import sys

from nnueehcs_tpu_torch import attrib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_forward_battery_gates_every_variant_on_the_cpu(capsys):
    out = attrib.forward_battery('cpu', seed=1, rows=200)
    assert out['variants'] == {}          # no device time on the CPU
    gates = out['gates']
    assert {'prod', 'io_floor', 'one_out', 'gemm_only', 'no_epi',
            'members=1', 'layers=5', 'xT input', 'xT+outT', 'narrow-in',
            'narrow-out', 'narrow-both', 'packed'} <= set(gates)
    for name in ('prod', 'one_out', 'xT input', 'xT+outT', 'narrow-both',
                 'packed'):
        assert gates[name]['equals_kernel_1'], name
    assert not gates['gemm_only']['equals_kernel_1']
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert len(lines) == len(gates) + 1
    assert all(l['battery'] == 'forward' for l in lines)


def test_train_battery_gates_every_variant_on_the_cpu():
    out = attrib.train_battery('cpu', seed=2, steps=8)
    gates = out['gates']
    binding = f'gn_fused clip={attrib.BINDING_CLIP:g}'
    batches = {f'prod B={b}' for b in attrib.BATCHES if b != attrib.BATCH}
    timed = {'unroll2_vs_prod', 'unroll4_vs_prod', 'ch4096_vs_prod',
             'ch8_vs_prod', 'unroll4+gn+ch4096_vs_gn_fused'}
    assert set(gates) == set(attrib.TRAIN_VARIANTS) | {
        'prod_vs_kernel_3', binding} | batches | timed
    for name in {'prod_vs_kernel_3'} | timed:
        assert gates[name]['bit_for_bit'] and gates[name]['steps'] == 8
    for name in batches:
        assert gates[name]['bit_for_bit_with_kernel_3']
        assert gates[name]['stepwise']['steps'] == attrib.GATE_STEPS
        assert gates[name]['stepwise']['over_tol_outside_reach'] == 0
    for name in set(attrib.TRAIN_VARIANTS) | {binding}:
        errs = gates[name]['max_abs_err']
        assert set(errs) == set(attrib.TOL_TRAIN), name
        mode = attrib.TRAIN_VARIANTS.get(name, {}).get('mode', 'prod')
        assert ('grad_norm' in gates[name]) == (mode in ('prod', 'no_opt'))
    # the ordinary gates' clip (5) does not bind; the binding gate's does,
    # on every step
    assert gates['gn_fused']['clip_binds_steps'] == 0
    assert gates[binding]['clip'] == attrib.BINDING_CLIP
    assert gates[binding]['clip_binds_steps'] == attrib.GATE_STEPS
    assert gates[binding]['grad_norm'][0] >= attrib.BINDING_CLIP


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
