"""The SASS reader (``nnueehcs_tpu_torch.sass``), row 2b's mask-hash bound,
row 4's bound by pipe (``ops/kde.py kde_bound_terms``), the phase-stamp
reader of ``ops/_build.py`` and the phase tools' arithmetic,
on the CPU: synthetic ``cuobjdump -sass`` listings and stamp words stand in
for what the card's toolchain gives."""
import ast
import ctypes
import importlib.util
import inspect
import os

import pytest

import chip_smoke
from nnueehcs_tpu_torch import sass
from nnueehcs_tpu_torch.ops import _build
from nnueehcs_tpu_torch.ops import fused_mc_dropout as mc
from nnueehcs_tpu_torch.ops import kde

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, 'tools', f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def listing(functions):
    """A cuobjdump-style listing of {name: [instruction text]}, 16 bytes an
    instruction, each followed by its control word."""
    lines = []
    for name, instrs in functions.items():
        lines.append(f'\t\tFunction : {name}')
        lines.append('\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"')
        for i, text in enumerate(instrs):
            lines.append(f'        /*{16 * i:04x}*/                   {text} ;'
                         f'   /* 0x{i:016x} */')
            lines.append(f'                                             '
                         f'   /* 0x000fe2000{i:07x} */')
    return '\n'.join(lines)


def mask_loop(per_hash_extra=0, hashes=2):
    """A kernel body whose inner loop does ``hashes`` lowbias32 hashes of 9
    instructions each (two of them IMADs), plus ``per_hash_extra`` others a
    hash, inside an outer loop of 20 more instructions."""
    body = ['MOV R1, c[0x0][0x28]'] + ['NOP'] * 3
    outer_start = len(body)
    body += ['IADD3 R9, R9, 0x1, RZ'] * 20
    inner_start = len(body)
    for _ in range(hashes):
        body += ['SHF.R.U32.HI R3, RZ, 0x10, R2', 'LOP3.LUT R2, R2, R3, RZ, 0x3c, !PT',
                 'IMAD R2, R2, 0x7feb352d, RZ', 'SHF.R.U32.HI R3, RZ, 0xf, R2',
                 'LOP3.LUT R2, R2, R3, RZ, 0x3c, !PT', 'IMAD R2, R2, -0x7b935975, RZ',
                 'SHF.R.U32.HI R3, RZ, 0x10, R2', 'LOP3.LUT R2, R2, R3, RZ, 0x3c, !PT',
                 'LEA.HI R4, R2, -R5, RZ, 0x18']
        body += ['SHF.L.W.U32.HI R6, R4, 0x1, R6'] * per_hash_extra
    body.append(f'@P0 BRA 0x{16 * inner_start:x}')
    body.append(f'@P1 BRA 0x{16 * outer_start:x}')
    body += ['HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24', 'EXIT']
    return body


def eval_kernels(mc_body):
    """SASS ({name: [(address, text)]}) and a ptxas report of both forms of
    the bf16 eval kernels (the MC kernels' resident form ``mc_body``) and of
    the fp32 kernels 2 and 5 (3xTF32, one form each)."""
    bodies = {}
    ptxas = {}
    for kernel in sass.EVAL_KERNELS:
        for _, tag in sass.EVAL_FORMS:
            name = f'_ZN12_GLOBAL__N_1{len(kernel)}{kernel}{tag}Ev'
            resident = tag == 'ILb0E'
            bodies[name] = (mc_body if kernel.startswith('fused_mc') and resident
                            else ['HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24',
                                  'EXIT'])
            ptxas[name] = {'registers': 168, 'spill_store_bytes': 0,
                           'spill_load_bytes': 0}
    for kernel in sass.TF32_KERNELS:
        name = f'_ZN12_GLOBAL__N_1{len(kernel)}{kernel}Ev'
        bodies[name] = ['HGMMA.64x128x8.F32.TF32 R24, R104, gdesc[UR16], R24',
                        'EXIT']
        ptxas[name] = {'registers': 250, 'spill_store_bytes': 0,
                       'spill_load_bytes': 0}
    return sass.parse_instructions(listing(bodies)), ptxas


def test_parse_functions_drops_addresses_padding_and_the_file_hash():
    body = ['MOV R1, c[0x0][0x28]', 'EXIT']
    a = listing({'_ZN37_GLOBAL__N__1a2b3c4d_12_fused_ab_cu_0badf00d6kernelEv':
                 body})
    b = listing({'_ZN37_GLOBAL__N__99999999_12_fused_ab_cu_12345678'
                 '6kernelEv': body}).replace('        /*', '  /*')
    fa, fb = sass.parse_functions(a), sass.parse_functions(b)
    assert list(fa) == ['_ZN37_GLOBAL_6kernelEv']
    assert fa == fb
    assert len(fa['_ZN37_GLOBAL_6kernelEv']) == 4     # 2 instructions, 2 words


def test_parse_instructions_and_opcode():
    funcs = sass.parse_instructions(listing({'k': ['@P0 BRA 0x10',
                                                   'IMAD.IADD R1, R2, 0x1, R3']}))
    assert funcs == {'k': [(0, '@P0 BRA 0x10'),
                           (16, 'IMAD.IADD R1, R2, 0x1, R3')]}
    assert [sass.opcode(t) for _, t in funcs['k']] == ['BRA', 'IMAD.IADD']


@pytest.mark.parametrize('hashes,extra', [(1, 0), (2, 0), (2, 3), (4, 1)])
def test_loop_mix_takes_the_innermost_loop_of_the_marker(hashes, extra):
    instrs = sass.parse_instructions(
        listing({'k': mask_loop(extra, hashes)}))['k']
    mix = sass.loop_mix(instrs, sass.HASH_MARKER)
    per_hash = 9 + extra
    assert mix['markers'] == hashes
    assert mix['instructions'] == hashes * per_hash + 1       # + the branch
    assert mix['per_marker'] == pytest.approx(per_hash + 1 / hashes)
    assert mix['fma_pipe_per_marker'] == 2
    assert mix['opcodes']['LOP3.LUT'] == 3 * hashes


def test_loop_mix_finds_no_loop_without_the_marker():
    instrs = sass.parse_instructions(listing({'k': ['NOP', 'BRA 0x0']}))['k']
    assert sass.loop_mix(instrs, sass.HASH_MARKER) is None


def test_eval_chain_rows_reads_registers_hgmma_and_the_mask_loop():
    funcs, ptxas = eval_kernels(mask_loop())
    rows = sass.eval_chain_rows(funcs, ptxas)
    assert rows['mask_loop']['per_marker'] == pytest.approx(9.5)
    for kernel in sass.EVAL_KERNELS:
        for form, _ in sass.EVAL_FORMS:
            assert rows[f'{kernel}<{form}>']['hgmma'] >= 1
            assert rows[f'{kernel}<{form}>']['spill_store_bytes'] == 0
    for kernel in sass.TF32_KERNELS:
        assert rows[kernel] == {'registers': 250, 'spill_store_bytes': 0,
                                'spill_load_bytes': 0, 'hgmma': 1,
                                'hgmma_waited': 0, 'ptxas_serialised': []}
    assert rows[sass.TF32_MASK_LOOP] is None     # no loop in this listing


@pytest.mark.parametrize('fault', ['spill', 'no_hgmma', 'no_loop',
                                   'loop_too_long', 'missing_form',
                                   'tf32_spill', 'tf32_no_hgmma',
                                   'tf32_missing', 'tf32_serialised',
                                   'tf32_c7520', 'ensemble_serialised'])
def test_eval_chain_rows_refuses(fault):
    body = mask_loop(per_hash_extra=37 if fault == 'loop_too_long' else 0)
    if fault == 'no_loop':
        body = [t for t in body if 'BRA' not in t]
    funcs, ptxas = eval_kernels(body)
    name = next(n for n in funcs if 'ILb1E' in n)
    log = ''
    if fault.startswith('tf32_'):
        name = next(n for n in funcs if sass.TF32_KERNELS[0] in n)
        fault = fault[len('tf32_'):].replace('missing', 'missing_form')
    if fault == 'ensemble_serialised':
        name = next(n for n in funcs if 'fused_ensemble_kernel' in n)
        fault = 'serialised'
    if fault == 'spill':
        ptxas[name]['spill_store_bytes'] = 8
    elif fault == 'no_hgmma':
        funcs[name] = [(0, 'EXIT')]
    elif fault == 'missing_form':
        del funcs[name]
    elif fault == 'serialised':
        funcs[name] = sass.parse_instructions(listing(
            {name: hgmma_listing(serialised=True)}))[name]
    elif fault == 'c7520':
        log = ptxas_warning(name)
    with pytest.raises(RuntimeError, match='' if fault != 'serialised'
                       and fault != 'c7520' else 'serialised'):
        sass.eval_chain_rows(funcs, ptxas, log)


def hgmma_listing(serialised, steps=4):
    """A 3xTF32 body of ``steps`` k steps: pipelined, each layer's products
    issued together and waited on once (a WARPGROUP.DEPBAR), or as ptxas
    serialises them, an arrive before and a wait after every HGMMA."""
    body = ['MOV R1, c[0x0][0x28]']
    hgmma = 'HGMMA.64x128x8.F32.TF32 R24, R104, gdesc[UR16], R24'
    for _ in range(2):                   # two layers
        body.append('WARPGROUP.ARRIVE')
        for i in range(3 * steps):
            if serialised:
                body += [f'{hgmma}, gsb0', 'WARPGROUP.DEPBAR.LE gsb0, 0x0',
                         'WARPGROUP.ARRIVE']
            else:
                body.append(hgmma + (', gsb0' if i == 3 * steps - 1
                                     else ''))
        if not serialised:
            body.append('WARPGROUP.DEPBAR.LE gsb0, 0x0')
        body += ['FADD R24, R24, R3'] * 4
    return body + ['EXIT']


def ptxas_warning(name):
    """ptxas's line for a function whose wgmma it serialised."""
    return ("ptxas info    : (C7520) Potential Performance Loss: "
            "wgmma.mma_async instructions are serialized due to non "
            "wgmma instructions defining accumulator registers of a wgmma "
            f"between start and end of the pipeline stage in the function "
            f"'{name}'\nptxas info    : Used 168 registers")


@pytest.mark.parametrize('serialised', [False, True])
def test_waited_hgmma_tells_serialised_from_pipelined(serialised):
    instrs = sass.parse_instructions(listing(
        {'k': hgmma_listing(serialised)}))['k']
    assert sass.waited_hgmma(instrs) == (24 if serialised else 2)


def test_serialised_warnings_name_the_functions():
    log = '\n'.join([ptxas_warning('_Z1akernel'), 'ptxas info    : x',
                     ptxas_warning('_Z1bkernel').replace('C7520', 'C7510'),
                     "ptxas info    : Compiling entry function '_Z1ckernel'"])
    assert sass.serialised_warnings(log) == {'_Z1akernel': ['C7520'],
                                             '_Z1bkernel': ['C7510']}
    assert sass.serialised_warnings('ptxas info    : Used 9 registers') == {}


def test_eval_chain_rows_reports_the_bf16_kernels_serialised():
    """The bf16 kernels (1b, 2b, 5b) are known serialised: their rows carry
    the waits and ptxas's codes, and the gate passes."""
    funcs, ptxas = eval_kernels(mask_loop())
    name = next(n for n in funcs if 'fused_ensemble_bf16_kernel' in n
                and 'ILb1E' in n)
    funcs[name] = sass.parse_instructions(listing(
        {name: hgmma_listing(serialised=True)}))[name]
    rows = sass.eval_chain_rows(funcs, ptxas, ptxas_warning(name))
    row = rows['fused_ensemble_bf16_kernel<ring>']
    assert row['hgmma'] == row['hgmma_waited'] == 24
    assert row['ptxas_serialised'] == ['C7520']
    for kernel in sass.TF32_KERNELS:
        assert rows[kernel]['ptxas_serialised'] == []


def _binops(fn, op):
    tree = ast.parse(inspect.getsource(fn))
    return sum(isinstance(n, ast.BinOp) and isinstance(n.op, op)
               for n in ast.walk(tree))


def test_mask_hash_ops_are_the_functions_own():
    # lowbias32: three xor-shifts and two multiplies (by _mul32)
    assert _binops(mc.lowbias32, ast.RShift) == 3
    assert _binops(mc.lowbias32, ast.BitXor) == 3
    calls = [n.func.id for n in ast.walk(ast.parse(inspect.getsource(
        mc.lowbias32))) if isinstance(n, ast.Call)]
    assert calls.count('_mul32') == 2
    # the threshold test: one shift and one compare
    src = inspect.getsource(mc.dropout_scale)
    assert '(bits >> 8) < threshold' in src
    ops = mc.MASK_HASH_OPS
    assert ops['alu'] == 3 + 3 + 1          # shifts and xors
    assert ops['fma'] == 2                  # the multiplies
    assert ops['either'] == 2               # the column add, the compare
    assert sum(ops.values()) == 11


@pytest.mark.parametrize('ops,clocks', [
    (mc.MASK_HASH_OPS, 7 / 64),             # the ALU pipe bounds it
    ({'alu': 0, 'fma': 0, 'either': 4}, 2 / 64),
    ({'alu': 1, 'fma': 9, 'either': 0}, 9 / 64),
    ({'alu': 4, 'fma': 4, 'either': 0}, 4 / 64),
    ({'alu': 3, 'fma': 1, 'either': 6}, 5 / 64)])
def test_hash_clocks_balances_the_pipes(ops, clocks):
    assert chip_smoke.hash_clocks(ops) == pytest.approx(clocks)


class _FakeStamps:
    """A stamped library whose reader fills slot i with i and the wall word
    with 1e6, or returns ``err``."""

    def __init__(self, err=0):
        self.err = err
        self.reads = []

    def __getattr__(self, name):
        def read(address):
            self.reads.append(name)
            words = (ctypes.c_ulonglong * (_build.STAMP_SLOTS + 1)).from_address(
                address)
            for i in range(_build.STAMP_SLOTS):
                words[i] = i
            words[_build.STAMP_SLOTS] = 10 ** 6
            return self.err
        return read


def test_read_stamps_gives_slots_and_wall_time():
    lib = _FakeStamps()
    cycles, wall_ns = _build.read_stamps(lib, 'fused_mc_dropout')
    assert lib.reads == ['nnueehcs_stamps_fused_mc_dropout']
    assert cycles == list(range(_build.STAMP_SLOTS))
    assert wall_ns == 10 ** 6
    assert set(_build.STAMPED_UNITS) == {'fused_train', 'fused_train_bf16',
                                         'fused_mc_dropout', 'fused_anchored',
                                         'fused_ensemble', 'kde'}


def test_read_stamps_raises_on_a_cuda_error():
    with pytest.raises(RuntimeError, match='CUDA error 700'):
        _build.read_stamps(_FakeStamps(err=700), 'fused_train')


def test_stamps_header_is_the_only_stamp_mechanism():
    texts = {p.name: p.read_text() for p in
             [*_build.sources(), *_build.CSRC.glob('*.cuh')]}
    assert 'stamps.cuh' in texts
    for name, text in texts.items():
        for old in ('TRAIN_STAMP', 'EVAL_PHASE', 'NNUEEHCS_TRAIN_STAMPS',
                    'NNUEEHCS_EVAL_STAMPS', 'g_eval_sums'):
            assert old not in text, (name, old)
    readers = sorted(name for name, text in texts.items()
                     if 'STAMPS_READER(' in text and name != 'stamps.cuh')
    assert readers == sorted(f'{u}.cu' for u in _build.STAMPED_UNITS)
    for unit in _build.STAMPED_UNITS:
        assert f'STAMPS_READER({unit})' in texts[f'{unit}.cu']


def test_eval_phase_split_scales_cycles_by_wall_time():
    phases = tool('eval_chain_phases')
    cycles = [0] * _build.STAMP_SLOTS
    cycles[3], cycles[4], cycles[6] = 2000, 1000, 1000   # 4,000 cycles
    us, per_ns = phases.split(cycles, 2000)             # in 2 us
    assert per_ns == 2.0
    assert us == {'products_issue': 1.0, 'mask_hash_in_flight': 0.5,
                  'epilogue': 0.5}


@pytest.mark.parametrize('joint', [False, True])
def test_train_phases_sum_each_span_once(joint):
    phases = tool('train_step_phases')
    n = 3
    us = [0.0] * _build.STAMP_SLOTS
    base = 100 if joint else 300
    fired = ([950, 951] if joint else []) + [900, 901, 903, 904, 905]
    if joint:
        fired.append(902)
    for li in range(n - 1):
        fired += [base + 10 * li + j for j in phases.FWD.values()]
    fired += [base + 10 * (n - 1), base + 10 * (n - 1) + 1]
    for li in range(n - 1, -1, -1):
        fired += [500 + 10 * li + j for j in phases.BWD.values()
                  if li > 0 or j <= phases.BWD['dW_and_bias']]
    for i, slot in enumerate(fired):
        us[slot] = 1.0 + i
    out = phases.phases(us, n, joint)
    total = sum(us)
    step = out['step_launch'] + (out['sweep_launch'] if joint else 0.0)
    assert step == pytest.approx(total)
    assert out['backward'] == pytest.approx(
        us[904] + sum(sum(r.values()) for r in out['backward_layers']))
    assert len(out['backward_layers'][-1]) == 4        # layer 0 stops at dW
    if not joint:
        assert out['forward'] == pytest.approx(
            us[900] + sum(sum(r.values()) for r in out['forward_layers']))


KDE_PAIRS, SMS, CLOCK = 262_144 * 16_384, 132, 1.98e9


def test_kde_bound_counts_each_pipe_and_takes_the_least_choice():
    out = kde.kde_bound_terms(KDE_PAIRS, 5, SMS, CLOCK, 495e12)
    mufu_only = 1e3 * KDE_PAIRS / 16 / (SMS * CLOCK)       # 1.027 ms
    assert out['mufu_only_ms'] == pytest.approx(mufu_only)
    assert out['mufu_only_ms'] == pytest.approx(1.0271, abs=1e-4)
    assert out['ms'] == max(out['pipes_ms'].values())
    # moving a share of the exps to the FMA pipe beats the MUFU floor, until
    # instruction issue (128 a clock per SM) binds beside MUFU
    assert out['cross'] == 'tensor' and 0.5 < out['mufu_share'] < 1.0
    assert out['ms'] < mufu_only
    assert out['pipes_ms']['issue'] == pytest.approx(out['ms'], rel=2e-3)
    assert out['pipes_ms']['mufu'] == pytest.approx(out['ms'], rel=2e-3)
    # the 3xTF32 dot of depth 8: 48 FLOP a pair at the TF32 peak
    assert out['pipes_ms']['tensor'] == pytest.approx(
        1e3 * KDE_PAIRS * 48 / 495e12)


@pytest.mark.parametrize('d,depth', [(1, 8), (6, 8), (7, 16), (8, 16),
                                     (37, 40)])
def test_kde_bound_dot_depth_follows_d(d, depth):
    out = kde.kde_bound_terms(KDE_PAIRS, d, SMS, CLOCK, 495e12, steps=10)
    if out['cross'] == 'tensor':
        assert out['pipes_ms']['tensor'] == pytest.approx(
            1e3 * KDE_PAIRS * 6 * depth / 495e12)
    assert out['ms'] >= 1e3 * KDE_PAIRS * (
        kde.LSE_OPS['alu'] / kde.PIPE_RATES['alu']) / (SMS * CLOCK)


def test_eval_phase_names_cover_the_cluster_exchange_and_kde():
    phases = tool('eval_chain_phases')
    assert {phases.NAMES[i] for i in (11, 12, 13)} == {
        'dsmem_send', 'dsmem_wait', 'member_statistics'}
    us, _ = phases.split([0, 10, 20, 30, 40] + [0] * (_build.STAMP_SLOTS - 5),
                         100, phases.KDE_NAMES)
    assert list(us) == ['reference_staging', 'tensor_core_products',
                        'log_sum_exp', 'merge_and_write']
