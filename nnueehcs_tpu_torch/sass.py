"""Read the SASS of the port's kernel library (``cuobjdump -sass``, on a
machine with the CUDA toolkit): the per-kernel listings that
``tools/compare_sass.py`` compares between two builds, and the checks
``chip_smoke.py`` and ``tools/eval_chain_phases.py`` make of the eval
kernels on wgmma, the bf16 1b, 2b and 5b, the fp32 (3xTF32) 1, 2 and 5 and
the fp32 probe of kernel 1 on kernel 1's body (no spills, HGMMA
instructions, the MC kernels' mask loops, and whether ptxas serialised the
``wgmma``: a ``WARPGROUP.DEPBAR`` wait after each ``HGMMA``, and its C75xx
warnings in the ``-Xptxas -v`` log).
"""
from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path

_ANON = re.compile(r'_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}')
_ADDR = re.compile(r'/\*[0-9a-f]{4,}\*/')

# the lowbias32 multiply that every mask hash does once (fused_mc_dropout.cu)
HASH_MARKER = '0x7feb352d'
# instructions a hash that the MC kernel's mask loop may spend, around the
# hash's 11 operations (ops/fused_mc_dropout.py MASK_HASH_OPS): fewer where
# an instruction does two (a shift and an add in LEA.HI), more for packing
# the keep bits and the loop's own; outside, the loop search found another
# loop than the mask loop
MASK_LOOP_WINDOW = (8.0, 16.0)
EVAL_KERNELS = ('fused_mc_dropout_bf16_kernel', 'fused_anchored_bf16_kernel',
                'fused_ensemble_bf16_kernel',
                'fused_mc_dropout_bf16_table_kernel', 'packed_bf16_kernel')
# the rows' keys of the MC kernels' mask loops: the serving kernel's and
# the seed-table kernel's (a batched validation pass)
MASK_LOOPS = {'fused_mc_dropout_bf16_kernel': 'mask_loop',
              'fused_mc_dropout_bf16_table_kernel': 'mask_loop_table'}
# the template argument kRing of each form in the mangled name
EVAL_FORMS = (('resident', 'ILb0E'), ('ring', 'ILb1E'))
# the fp32 kernels 1, 2 and 5 (3xTF32 on wgmma, one form each: the ring);
# the MC kernel's mask loop is reported under its key, not held to the
# window
TF32_KERNELS = ('fused_mc_dropout_kernel', 'fused_anchored_kernel',
                'fused_ensemble_kernel')
TF32_MASK_LOOP = 'mask_loop_tf32'
# the fp32 probe of kernel 1 (ablate_forward, csrc/ablate_chain.cu
# ablate_tf32_kernel<mode, cut>): kernel 1's body in each form, held to the
# fp32 kernels' gate; io_floor runs no chain (no HGMMA): its registers and
# spills only
TF32_PROBE = 'ablate_tf32_kernel'
TF32_PROBE_FORMS = (('prod', 'ILi0ELb0EE'), ('prod cut', 'ILi0ELb1EE'),
                    ('gemm_only', 'ILi2ELb0EE'), ('no_epi', 'ILi3ELb0EE'),
                    ('no_epi cut', 'ILi3ELb1EE'))
TF32_PROBE_IO_FLOOR = ('io_floor', 'ILi1ELb0EE')
# ptxas's warning that it serialised a function's wgmma (C7510-C7520 name
# the causes: a branch between wgmma forms, an accumulator touched inside
# the pipeline, ...), with the function's mangled name last on the line
_SERIALISED = re.compile(r"\((C75\d\d)\)[^\n]*wgmma[^\n]*serializ[^\n]*"
                         r"'([^'\s]+)'")


def serialised_warnings(log: str) -> dict[str, list[str]]:
    """{mangled name: [C75xx codes]} of the functions whose wgmma ptxas
    reported serialised in an ``-Xptxas -v`` log."""
    out = {}
    for code, name in _SERIALISED.findall(log):
        out.setdefault(name, []).append(code)
    return out


def waited_hgmma(instrs) -> int:
    """The HGMMA instructions of a SASS function (``[(address, text)]``)
    that a ``WARPGROUP.DEPBAR`` waits on before the next HGMMA is issued:
    every one where ptxas serialised the wgmma, one a committed group
    where it pipelined them (a 3xTF32 k step issues three at least)."""
    waited, pending = 0, False
    for _, text in instrs:
        op = opcode(text)
        if op.startswith('HGMMA'):
            pending = True
        elif op.startswith('WARPGROUP.DEPBAR') and pending:
            waited += 1
            pending = False
    return waited


def _gate(name, funcs, ptxas, kernel, tag='', log='', pipelined=False,
          wgmma=True):
    """Registers, spills (which must be 0) and HGMMA instructions (which
    must be there, unless not ``wgmma``) of the one SASS function and
    ptxas entry whose names hold ``kernel`` and ``tag``, with the HGMMA a
    wait follows and ptxas's serialisation warnings (``log``); raise where
    one does not hold, and with ``pipelined`` where the wgmma are
    serialised (more than half the HGMMA waited on, or a warning)."""
    names = [n for n in funcs if kernel in n and tag in n]
    regs = [v for k, v in ptxas.items() if kernel in k and tag in k]
    if len(names) != 1 or len(regs) != 1:
        raise RuntimeError(f'{name}: {len(names)} SASS functions, '
                           f'{len(regs)} ptxas entries')
    row = {k: regs[0].get(k) for k in ('registers', 'spill_store_bytes',
                                      'spill_load_bytes')}
    row['hgmma'] = sum('HGMMA' in t for _, t in funcs[names[0]])
    row['hgmma_waited'] = waited_hgmma(funcs[names[0]])
    row['ptxas_serialised'] = [
        code for fn, codes in serialised_warnings(log).items()
        if kernel in fn and tag in fn for code in codes]
    if row['spill_store_bytes'] != 0 or row['spill_load_bytes'] != 0:
        raise RuntimeError(f'{name} spills: {row}')
    if wgmma and row['hgmma'] == 0:
        raise RuntimeError(f'{name}: no HGMMA in its SASS')
    if pipelined and (2 * row['hgmma_waited'] > row['hgmma']
                      or row['ptxas_serialised']):
        raise RuntimeError(f'{name}: ptxas serialised its wgmma: {row}')
    return row, names[0]


def cuobjdump() -> str:
    found = shutil.which('cuobjdump')
    return found or str(Path('/usr/local/cuda/bin/cuobjdump'))


def dump(lib) -> str:
    """``cuobjdump -sass`` of the library ``lib``."""
    return subprocess.run([cuobjdump(), '-sass', str(lib)], check=True,
                          capture_output=True, text=True).stdout


def parse_functions(text: str) -> dict[str, list[str]]:
    """{normalised mangled name: [SASS lines]} of a listing: each
    instruction with its encoding, and the control words; the per-file hash
    of the anonymous namespace, the address comments and the column padding
    (which cuobjdump sets per file) taken out."""
    funcs, name = {}, None
    for line in text.splitlines():
        head = re.match(r'\s*Function : (\S+)', line)
        if head:
            name = _ANON.sub('_GLOBAL_', head.group(1))
            funcs[name] = []
        elif name is not None and '/*' in line:   # instructions, control
            funcs[name].append(' '.join(_ADDR.sub('', line).split()))
    return funcs


def parse_instructions(text: str) -> dict[str, list[tuple[int, str]]]:
    """{mangled name: [(address, instruction)]} of a listing, the
    instruction text without its encoding."""
    funcs, name = {}, None
    for line in text.splitlines():
        head = re.match(r'\s*Function : (\S+)', line)
        if head:
            name = head.group(1)
            funcs[name] = []
            continue
        ins = re.match(r'\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;', line)
        if name is not None and ins:
            funcs[name].append((int(ins.group(1), 16), ins.group(2)))
    return funcs


def opcode(text: str) -> str:
    """The opcode of an instruction, its predicate guard dropped."""
    words = text.split()
    if words and words[0].startswith('@'):
        words = words[1:]
    return words[0] if words else ''


def loop_mix(instrs, marker):
    """The loop (a backward branch and the instructions from its target to
    it) where instructions that contain ``marker`` are densest, the
    innermost one that holds them: its instruction count, the markers in
    it, instructions per marker, the FMA-pipe ones (IMAD, IMUL) per marker
    and the opcode counts; None when no loop holds one."""
    best = None
    for addr, text in instrs:
        if not opcode(text).startswith('BRA'):
            continue
        target = re.search(r'0x([0-9a-f]+)', text.split('BRA', 1)[1])
        if not target or int(target.group(1), 16) >= addr:
            continue
        lo = int(target.group(1), 16)
        body = [t for a, t in instrs if lo <= a <= addr]
        hits = sum(marker in t for t in body)
        if hits and (best is None
                     or len(body) / hits < best['per_marker']):
            ops = {}
            for t in body:
                ops[opcode(t)] = ops.get(opcode(t), 0) + 1
            fma = sum(n for op, n in ops.items()
                      if op.startswith(('IMAD', 'IMUL')))
            best = {'instructions': len(body), 'markers': hits,
                    'per_marker': len(body) / hits,
                    'fma_pipe_per_marker': fma / hits, 'opcodes': ops}
    return best


def eval_chain_rows(funcs, ptxas, log=''):
    """The bf16 eval kernels 1b, 2b (and 2b's seed-table kernel), 5b and
    the packed probe 10b in both forms (resident, ring), the fp32 kernels
    1, 2 and 5 (3xTF32) and the fp32 probe of kernel 1 in each form
    (TF32_PROBE_FORMS, and its io_floor without HGMMA),
    from the SASS ``funcs`` (:func:`parse_instructions`), the ptxas report
    ``ptxas`` ({kernel: {'registers', 'spill_store_bytes', ...}}) and the
    ``-Xptxas -v`` log ``log``: their registers and spills, which must be 0,
    their HGMMA (wgmma) instructions, which must be there, and those a wait
    follows with ptxas's serialisation warnings, which the fp32 kernels must
    not have (the bf16 ones are reported: their layer 0 still chooses its
    first product by a branch); and the bf16 MC kernels' mask loops, whose
    instructions per hash (per lowbias32 multiply by HASH_MARKER) must lie
    in MASK_LOOP_WINDOW (the fp32 MC kernel's is reported). Raises
    RuntimeError where one does not hold."""
    out = {}
    for kernel in TF32_KERNELS:
        out[kernel], name = _gate(kernel, funcs, ptxas, kernel, log=log,
                                  pipelined=True)
        if kernel == 'fused_mc_dropout_kernel':
            out[TF32_MASK_LOOP] = loop_mix(funcs[name], HASH_MARKER)
    for form, tag in TF32_PROBE_FORMS:
        key = f'{TF32_PROBE}<{form}>'
        out[key], _ = _gate(key, funcs, ptxas, TF32_PROBE, tag, log,
                            pipelined=True)
    form, tag = TF32_PROBE_IO_FLOOR
    key = f'{TF32_PROBE}<{form}>'
    out[key], _ = _gate(key, funcs, ptxas, TF32_PROBE, tag, log, wgmma=False)
    for kernel in EVAL_KERNELS:
        for form, tag in EVAL_FORMS:
            row, name = _gate(f'{kernel}<{form}>', funcs, ptxas, kernel, tag,
                              log)
            out[f'{kernel}<{form}>'] = row
            if kernel in MASK_LOOPS and form == 'resident':
                mask = loop_mix(funcs[name], HASH_MARKER)
                if mask is None:
                    raise RuntimeError('no mask loop in the MC kernel SASS')
                lo, hi = MASK_LOOP_WINDOW
                if not lo <= mask['per_marker'] <= hi:
                    raise RuntimeError(
                        f'the MC kernel mask loop found spends '
                        f'{mask["per_marker"]} instructions a hash, outside '
                        f'{MASK_LOOP_WINDOW}: {mask}')
                out[MASK_LOOPS[kernel]] = mask
    return out


def eval_chain_sass(lib_path, ptxas, log=''):
    """:func:`eval_chain_rows` of the library at ``lib_path``."""
    return eval_chain_rows(parse_instructions(dump(lib_path)), ptxas, log)
