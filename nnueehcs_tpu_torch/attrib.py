"""Kernel attribution on the card: where the time of kernels 1 and 3 goes.

The batteries of the JAX package's TPU probes, ported to the card:
``experiments/grid_r5/attrib_eval.py`` and ``attrib_eval2.py`` and the fp32
and bf16 packed variants of ``experiments/grid_r4/kernel_variants.py``
(``forward``: kernel
1, the fused ensemble pass) and ``experiments/grid_r5/attrib_train.py``
(``train``: kernel 3, the fused training epoch), on the flagship ensemble
built by this package's own builder (8 members, 5 inputs, 6 x [Linear 128 ->
BatchNorm1d -> ReLU], Linear 128 -> 1, weights from ``--seed``)::

    python -m nnueehcs_tpu_torch.attrib {forward,train} [--seed N]
        [--device cuda] [--rows N] [--steps N] [--reps N] [--bf16]

Each variant is first held to its plain PyTorch version on the same inputs
(and each form of kernel 1's former FFMA math to the ``prod`` probe, which
runs that body, bit for bit; kernel 1 itself, on the tensor cores, to its
plain version; kernel 3's
probe keeps the one-block form of its step, which the production kernel
left for one thread-block cluster per member, so the training battery
holds the production kernel to its plain version step by step and times
the two forms side by side), then timed: CUDA-event medians over
``--reps`` passes (or epochs) after warm-ups, with the spread of the
middle 60% and the variant's bound (fp32 operations over the card's peak,
or bytes over its memory rate). It prints one JSON line per gate and per
variant, then the decomposition lines: kernel 1 against the ``prod``
control (its former body), and the one-block form's per-step budget and the batch scaling
of both forms; with ``--bf16`` the training battery runs kernel 3's bf16
form (gates, epoch, batch scaling). The TPU-only items of the probes are
left out: the tile sweeps (the CUDA block is 64 rows, fixed by the
register tiling) and the MXU identity transpose (the kernel writes
feature-major outputs directly).

It runs on the card unless ``--device cpu`` is given; there the kernels'
plain versions run, at small sizes, the gates only: a CPU time is no
measure of the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from .convert import tensor_trees
from .model_builder import EnsembleModelBuilder
from .models.base import resolve_device
from .nn.layers import Linear
from .ops import ablate_epoch as ae
from .ops import ablate_forward as af
from .ops import fused_train as ft
from .ops.fused_ensemble import (fused_forward_plain, fused_forward_prefolded,
                                 prepare_fused_weights)

IN_DIM, WIDTH, MEMBERS = 5, 128, 8
ROWS = 262_144                 # the bench's evaluation batch
STEPS, BATCH = 500, 128        # attrib_train.py's epoch
BATCHES = (128, 256, 512, 1024)
CPU_ROWS, CPU_STEPS = 1024, 8  # the CPU's sizes (gates only)
# steps of each training gate: over more steps the two versions' parameters
# drift apart enough that the running statistics near the 1e-5 bar; every
# unroll divides it and STEPS
GATE_STEPS = 8
LR = 1e-3
# kernel vs plain (chip_smoke.py's too): mean 1e-5 and std 1e-3 relative
# (tests/test_torch_fused_ensemble.py); training absolute, losses 5e-6,
# moments 1e-6, parameters and running statistics 1e-5
# (tests/test_torch_fused_train.py); gn_fused and opt_chunk to the TPU
# probe's own gate (attrib_train.py: theta 1e-5, loss 1e-6)
TOL_MEAN = {'rtol': 1e-5, 'atol': 1e-5}
TOL_STD = {'rtol': 1e-3, 'atol': 1e-5}
TOL_TRAIN = {'theta': 1e-5, 'm': 1e-6, 'v': 1e-6, 'sigma': 1e-5,
             'losses': 5e-6}
TOL_PROBE = dict(TOL_TRAIN, losses=1e-6)
# each step's global gradient norm, relative: the kernel sums ~10^5 squares
# a member in another order, from parameters that differ within TOL_TRAIN
TOL_NORM = {'rtol': 1e-5, 'atol': 0.0}
# a bf16 form against its plain version, on the same outputs: the root
# mean square of the error at most BF16_RMS_SHARE of the bf16-vs-fp32
# gap's, and its largest value at most BF16_MAX_SHARE of the gap's
# largest. The two sum in another order, so a few bf16 roundings of hidden
# activations go the other way, one bf16 unit each: on the card, at the
# flagship widths, the largest such error reached 0.21-0.39 of the largest
# gap (a max is the worst flip's reach), so the quarter bar is on the root
# mean square, and the max bar catches a wrong row, which is off by the
# output's own size, far past the gap
BF16_RMS_SHARE = 0.2
BF16_MAX_SHARE = 1.0
# kernel 3's bf16 form against its plain version, step by step: the
# running statistics, the first moment m (the scaled gradient) and each
# parameter's change in the step by the bf16 bars above against the plain
# bf16-vs-fp32 gap of the same step. The per-step losses, one value a step,
# each a mean over the whole batch: the same bars, but their rms bar is at
# least BF16_WITNESS_SHARE times the rms distance between two correct
# plain bf16 versions, the plain epoch on the card and on the host, which
# sum in other orders (a flipped rounding of a hidden activation counts in
# every loss, while the bf16-vs-fp32 roundings partly cancel in the mean).
# The kernel's and the witness's errors are alike in distribution: over 16
# steps the ratio of their rms passes 2 in about one run of 200 (measured
# 0.59-1.53 on an H100).
# v is held to Adam's own update of the kernel's gradient, which m reveals
# (TOL_ADAM_V of fp32 round-off): a bf16-vs-fp32 gap of v weights each
# gradient's error by the gradient itself, so a max against it says little.
# On networks whose BatchNorm shifts keep every ReLU on one side
# (``separate_relu``), with dropout slots, two correct bf16 steps part by
# up to the whole gap on single steps: the plain step on the host goes past
# the per-step bars against the plain step on the card on 1-12 steps of
# 64, about as often as the kernel does, but on other steps
# (tools/bf16_mc_stepwise.py on an H100). There (``witnessed``) a step is
# held to the per-step bars widened to BF16_WITNESS_SHARE times how far
# the witnesses (the host's plain step, the plain step with its products
# on the tensor cores) part from the card's plain step on that same step;
# a step past them is an excursion, which must stay within
# BF16_WITNESS_SHARE times the gap's own rms and max (or the witnesses'
# shares, where larger), and there may be at most BF16_WITNESS_SHARE
# times as many excursions as steps on which a witness itself goes past
# the per-step bars (counted as at least one)
BF16_WITNESS_SHARE = 2.0
TOL_ADAM_V = 4.0
# an l1 sign decision taken the other way moves the output bias's gradient
# by at least 2 / batch of it (1/64 at 128 rows, 1/512 at 1,024), and
# round-off by under 1e-5 of it (loss_flips)
LOSS_FLIP_SHARE = 1e-3
# in fp32 a loss decision goes the other way only where a row's prediction
# minus target is within rounding of 0: the fp32 step-by-step gate credits
# loss flips on at most one step in LOSS_FLIP_STEPS (at least one), so a
# loss gradient that is wrong, and so "flips" on most steps, fails it (the
# card's fp32 runs showed none; the bf16 form's roundings flip more often
# and its bars are on the gap)
LOSS_FLIP_STEPS = 8
CLIP = 5.0                     # the flagship's gradient_clip_val
BINDING_CLIP = 1e-2            # below every step's gradient norm
# (name substring, fp32 non-tensor FLOP/s, memory bytes/s), NVIDIA data
# sheets at full power; the first match wins
PEAKS = [('H100 PCIe', 51.2e12, 2.0e12), ('H100 NVL', 60e12, 3.9e12),
         ('H200', 67e12, 4.8e12), ('H100', 67e12, 3.35e12)]
# (name substring, dense bf16 tensor-core FLOP/s), the same data sheets
BF16_PEAKS = [('H100 PCIe', 756e12), ('H100 NVL', 835e12), ('H200', 989e12),
              ('H100', 989e12)]


def flagship_arch(width=WIDTH, hidden=6, in_dim=IN_DIM):
    arch = []
    fan_in = in_dim
    for _ in range(hidden):
        arch += [{'Linear': {'args': [fan_in, width]}},
                 {'BatchNorm1d': {'args': [width]}}, {'ReLU': {}}]
        fan_in = width
    return arch + [{'Linear': {'args': [fan_in, 1]}}]


def flagship(seed, device, members=MEMBERS):
    return EnsembleModelBuilder(flagship_arch(), {'num_models': members},
                                train_config={'loss': 'l1_loss'}, seed=seed,
                                device=device).build()


def separate_relu(model, generator):
    """BatchNorm shifts of +3 or -3 per column (scales in [0.5, 1.5]): every
    pre-ReLU value then sits several units from 0, so a kernel and its
    plain version take the same ReLU branch everywhere and a whole epoch
    can be held to float32 round-off. A value within rounding of 0 may go
    either way in two implementations that sum in different orders. Half
    the columns are masked off, so the backward's ReLU masks stay
    exercised."""
    with torch.no_grad():
        for layer in model.net.layers:
            if hasattr(layer, 'running_var'):
                shape = layer.bias.shape
                sign = torch.randint(0, 2, shape, generator=generator) * 2 - 1
                layer.bias.copy_(3.0 * sign)
                layer.weight.copy_(torch.rand(shape, generator=generator) + 0.5)
    return model


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def emit(**fields):
    print(json.dumps(fields), flush=True)


def peaks(kind: str):
    """(fp32 FLOP/s, bytes/s) of the card named ``kind``, and their
    source."""
    for key, flops, moved in PEAKS:
        if key in kind:
            return flops, moved, key
    return 67e12, 3.35e12, 'not in table: H100 SXM assumed'


def bf16_peak(kind: str):
    """Dense bf16 tensor-core FLOP/s of the card named ``kind``."""
    return next((flops for key, flops in BF16_PEAKS if key in kind), 989e12)


def bound(flops, moved, peak_flops, peak_bytes, exps=0, ex2_rate=1.0,
          extra_s=0.0):
    """(bound_ms, bound_by): the largest of operations over their peak
    (``flops`` over ``peak_flops``, plus ``extra_s`` seconds of operations
    of another type), ``exps`` MUFU ex2 results over the ex2 rate, and bytes
    over the memory rate."""
    t_ops = max(flops / peak_flops + extra_s, exps / ex2_rate)
    t_bytes = moved / peak_bytes
    return 1e3 * max(t_ops, t_bytes), 'operations' if t_ops >= t_bytes \
        else 'bytes'


def event_ms(fn, warmup=5, trials=10):
    """Median, extremes and spread of ``trials`` passes after ``warmup``,
    each bracketed by CUDA events; the spread is the range of the middle
    60% over the median, in percent."""
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(trials)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    ms = sorted(s.elapsed_time(e) for s, e in pairs)
    med = ms[len(ms) // 2]
    trim = len(ms) // 5
    core = ms[trim:len(ms) - trim] if len(ms) > 2 * trim + 1 else ms
    return {'median_ms': med, 'min_ms': ms[0], 'max_ms': ms[-1],
            'spread_pct': 100.0 * (core[-1] - core[0]) / med}


# fp32 operations of a training step beside its products, per element:
# BatchNorm's forward (column sum, centre, square, sum, normalise, affine)
# and backward (four column sums of products, the gradient's update), the
# ReLU and its mask in the backward, and per parameter element the clip's
# square and scale, both moments and the update
BN_FWD_OPS, BN_BWD_OPS, RELU_OPS, ADAM_OPS = 7, 11, 2, 16


def train_rest_flops(plan, steps):
    """fp32 operations of ``steps`` training steps beside the GEMMs
    (BatchNorm, ReLU and the optimizer, at the true widths), the part of a
    bf16-mixed step that stays on the fp32 units."""
    rows = plan.batch * plan.num_members
    bn = rows * sum(L.out_w for L in plan.lins if L.bn_layer >= 0)
    relu = rows * sum(L.out_w for L in plan.lins if L.relu)
    params = plan.num_members * sum(
        (L.in_w + 1) * L.out_w + (2 * L.out_w if L.bn_layer >= 0 else 0)
        for L in plan.lins)
    return float(steps) * (bn * (BN_FWD_OPS + BN_BWD_OPS) + relu * RELU_OPS
                           + params * ADAM_OPS)


def train_flops(plan, steps):
    """GEMM FLOP of ``steps`` training steps at the true widths: one
    forward, the weight gradients, and the input gradients of every block
    but the first."""
    macs = plan.macs_per_row()
    dh = macs - plan.lins[0].in_w * plan.lins[0].out_w
    return 2.0 * steps * plan.batch * plan.num_members * (2 * macs + dh)


def nvidia_smi(query):
    try:
        out = subprocess.run(['nvidia-smi', f'--query-gpu={query}',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=60)
    except FileNotFoundError:
        return 'not available'
    return out.stdout.strip() if out.returncode == 0 else 'not available'


class _Card:
    """The device the battery runs on, and its peaks."""

    def __init__(self, device):
        self.device = device
        self.on_card = device.type == 'cuda'
        self.kind = torch.cuda.get_device_name(device) if self.on_card \
            else 'cpu'
        self.flops, self.bytes, self.peak_source = peaks(self.kind)
        self.bf16_flops = bf16_peak(self.kind)
        self.smi = nvidia_smi('name,power.limit') if self.on_card else 'cpu'


def _close(name, got, want, tol):
    """Max absolute error of ``got`` against ``want``; raises past
    ``tol``."""
    if got.shape != want.shape:
        raise RuntimeError(f'{name}: shape {tuple(got.shape)} != '
                           f'{tuple(want.shape)}')
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f'{name}: non-finite values')
    err = (got - want).abs()
    bad = err > tol['atol'] + tol['rtol'] * want.abs()
    if bool(bad.any()):
        raise RuntimeError(f'{name}: {int(bad.sum())} values off by up to '
                           f'{float(err.max()):.3e} (tolerance {tol})')
    return float(err.max())


def bf16_close(name, got, want, fp32, rms_share=BF16_RMS_SHARE, gate=True,
               witness=None):
    """Hold a bf16 form's output ``got`` to its plain version's ``want``
    against the bf16-vs-fp32 gap ``want - fp32`` on the same outputs: the
    error's root mean square within ``rms_share`` of the gap's (or, given
    ``witness``, another correct bf16 version's output, within
    BF16_WITNESS_SHARE of its rms distance to ``want`` where that is
    larger), its max within BF16_MAX_SHARE of the gap's max; raises past
    either (with ``gate`` False it only reports). Returns the errors, the
    gaps, the bars and the share of outputs beyond the fp32 bars
    (TOL_MEAN)."""
    if got.shape != want.shape or want.shape != fp32.shape:
        raise RuntimeError(f'{name}: shapes {tuple(got.shape)}, '
                           f'{tuple(want.shape)}, {tuple(fp32.shape)}')
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f'{name}: non-finite values')
    err = (got - want).double()
    gap = (want - fp32).double()
    out = {'max_abs_err': float(err.abs().max()),
           'rms_err': float(err.square().mean().sqrt()),
           'gap_max': float(gap.abs().max()),
           'gap_rms': float(gap.square().mean().sqrt())}
    out['bar_rms'] = rms_share * out['gap_rms']
    if witness is not None:
        out['witness_rms'] = float((witness.to(want.device) - want).double()
                                   .square().mean().sqrt())
        out['bar_rms'] = max(out['bar_rms'],
                             BF16_WITNESS_SHARE * out['witness_rms'])
    out['bar_max'] = BF16_MAX_SHARE * out['gap_max']
    verdict = bf16_verdict(name, out)
    if gate and verdict:
        raise RuntimeError(verdict)
    beyond = err.abs() > TOL_MEAN['atol'] + TOL_MEAN['rtol'] * want.abs()
    out['share_beyond_fp32_bars'] = float(beyond.double().mean())
    return out


def bf16_verdict(name, res):
    """None when :func:`bf16_close`'s result ``res`` is within both bars,
    else the message that names the bar it passed."""
    if (res['rms_err'] <= res['bar_rms']
            and res['max_abs_err'] <= res['bar_max']):
        return None
    return (f'{name}: error rms {res["rms_err"]:.3e} (bar '
            f'{res["bar_rms"]:.3e}), max {res["max_abs_err"]:.3e} (bar '
            f'{res["bar_max"]:.3e}); bf16-vs-fp32 gap rms '
            f'{res["gap_rms"]:.3e}, max {res["gap_max"]:.3e}')


def _equal(name, got, want):
    if not torch.equal(got, want):
        raise RuntimeError(f'{name}: not bit for bit '
                           f'(max {float((got - want).abs().max()):.3e})')


# ---------------------------------------------------------------------------
# kernel 1
# ---------------------------------------------------------------------------
def _layer_macs(net):
    return [l.in_features * l.out_features for l in net.layers
            if isinstance(l, Linear)]


def forward_inputs(seed, device, rows):
    """The flagship, its folded weights and ``rows`` rows of 5 normal
    features from ``seed``: ``(model, fw, x, x_pad, x_n8, x_t)``, with x as
    ``(rows, 5)``, zero-padded to 128 and to 8 columns, and feature-major
    ``(8, rows)``."""
    model = flagship(seed, device)
    fw = prepare_fused_weights(model.net)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(rows, IN_DIM)), dtype=torch.float32,
                        device=device)
    x_pad = F.pad(x, (0, WIDTH - IN_DIM)).contiguous()
    x_n8 = F.pad(x, (0, af.NARROW - IN_DIM)).contiguous()
    return model, fw, x, x_pad, x_n8, x_n8.T.contiguous()


def forward_battery(device='cuda', seed=0, rows=None, reps=10, warmup=3):
    """Gate and time kernel 1's probes on ``rows`` rows (default 262,144 on
    the card). Returns ``{'gates': {...}, 'variants': {name: {...}},
    'decomposition': {...}}``; prints each as a JSON line."""
    card = _Card(resolve_device(device))
    rows = rows or (ROWS if card.on_card else CPU_ROWS)
    model, fw, x, x_pad, x_n8, x_t = forward_inputs(seed, card.device, rows)
    macs = _layer_macs(model.net)
    M, L = fw.num_members, fw.num_layers

    def abl(mode='prod', n_out=2, members=None, layers=None):
        def run(plain=False):
            fn = af.ablate_forward_plain if plain else af.ablate_forward
            return fn(fw, x_pad, members, layers, af.TILE_ROWS, mode, n_out)
        return run

    def call(fn, plain_fn, *args):
        return lambda plain=False: (plain_fn if plain else fn)(fw, *args)

    def work(members=M, layers=L, n_out=2, ow=WIDTH, xin=rows * IN_DIM,
             chain=True):
        out_rows = rows * ow * n_out
        weights = fw.w_all.numel() + fw.b_all.numel()
        return (2.0 * rows * members * sum(macs[:layers]) if chain else 0.0,
                4.0 * (xin + out_rows + (weights if chain else 0)))

    # name: (run(plain=False), (flops, bytes), production-math output width)
    probes = {
        'prod': (abl(), work(), WIDTH),
        'io_floor': (abl('io_floor'), work(chain=False), None),
        'one_out': (abl(n_out=1), work(n_out=1), WIDTH),
        'gemm_only': (abl('gemm_only'), work(), None),
        'no_epi': (abl('no_epi'), work(), None),
        **{f'members={m}': (abl(members=m), work(members=m), None)
           for m in (1, 2, 4)},
        **{f'layers={l}': (abl(layers=l), work(layers=l), None)
           for l in (1, 3, 5)},
        'xT input': (call(af.xt_forward, af.xt_forward_plain, x_t), work(),
                     WIDTH),
        'xT+outT': (call(af.xt_forward, af.xt_forward_plain, x_t, True),
                    work(ow=af.NARROW), 'cols'),
        'narrow-in': (call(af.narrow_forward, af.narrow_forward_plain, x_n8,
                           True, False), work(), WIDTH),
        'narrow-out': (call(af.narrow_forward, af.narrow_forward_plain,
                            x_pad, False, True), work(ow=af.NARROW),
                       af.NARROW),
        'narrow-both': (call(af.narrow_forward, af.narrow_forward_plain,
                             x_n8, True, True), work(ow=af.NARROW),
                        af.NARROW),
        'packed': (call(af.packed_forward, af.packed_forward_plain, x_pad),
                   work(n_out=1), fw.out_dim),
    }
    # gates: each probe against its plain version; the forms of the
    # production math against the prod probe (kernel 1's former FFMA body,
    # which the probes share), bit for bit; kernel 1 (3xTF32 products on
    # the tensor cores) against its own plain version within the bars
    base = [t[:, :fw.out_dim] for t in probes['prod'][0]()]
    gates = {}
    for name, (run, _, prod_width) in probes.items():
        got, want = run(), run(plain=True)
        exact = name == 'io_floor'
        errs = [(_equal(f'{name} out{i}', g, w) or 0.0) if exact else
                _close(f'{name} out{i}', g, w,
                       TOL_MEAN if i == 0 or name == 'no_epi' else TOL_STD)
                for i, (g, w) in enumerate(zip(got, want))]
        if prod_width is not None:
            for i, (g, b) in enumerate(zip(got, base)):
                g = g[:fw.out_dim].T if prod_width == 'cols' else \
                    g[:, :fw.out_dim]
                _equal(f'{name} out{i}', g, b)
        gates[name] = {'max_abs_err': errs,
                       'equals_prod_probe': prod_width is not None}
        emit(battery='forward', gate=name, device=card.kind,
             max_abs_err_vs_plain=errs,
             bit_for_bit_with_prod_probe=prod_width is not None)
    errs = [_close(f'kernel 1 out{i}', g, w, TOL_MEAN if i == 0 else TOL_STD)
            for i, (g, w) in enumerate(zip(fused_forward_prefolded(fw, x),
                                           fused_forward_plain(fw, x)))]
    gates['kernel 1'] = {'max_abs_err': errs, 'equals_prod_probe': False}
    emit(battery='forward', gate='kernel 1', device=card.kind,
         max_abs_err_vs_plain=errs, bit_for_bit_with_prod_probe=False)
    # the packed probe's bf16 form: against its plain version within the
    # bf16 bars, and bit for bit against kernel 1's bf16 form
    model.set_precision('bf16-mixed')
    fw16 = prepare_fused_weights(model.net)
    model.set_precision('32-true')
    got = af.packed_forward(fw16, x_pad)
    want = af.packed_forward_plain(fw16, x_pad)
    ref32 = af.packed_forward_plain(fw, x_pad)
    errs16 = [bf16_close(f'packed bf16 out{i}', g, w, r)
              for i, (g, w, r) in enumerate(zip(got, want, ref32))]
    for i, (g, b) in enumerate(zip(got, fused_forward_prefolded(fw16, x))):
        _equal(f'packed bf16 out{i}', g, b)
    gates['packed bf16'] = {'max_abs_err': [e['max_abs_err'] for e in errs16],
                            'bf16': errs16, 'equals_kernel_1_bf16': True}
    emit(battery='forward', gate='packed bf16', device=card.kind,
         vs_plain=errs16, bit_for_bit_with_kernel_1_bf16=True)
    out = {'gates': gates, 'variants': {}, 'decomposition': {}}
    if not card.on_card:
        emit(battery='forward', device='cpu', rows=rows,
             note='plain versions only: no device time on the CPU')
        return out

    # e2e: from the raw (B, 5) rows, pad -> probe -> slice, as a model path
    # would run each layout
    def e2e_pad(width):
        return F.pad(x, (0, width - IN_DIM))

    timed = {name: (run, w) for name, (run, w, _) in probes.items()}
    timed.update({
        'split (kernel 1)': (lambda: fused_forward_prefolded(fw, x),
                             work(ow=fw.out_dim, xin=rows * IN_DIM)),
        'e2e prod': (lambda: [t[:, :1] for t in af.ablate_forward(
            fw, e2e_pad(WIDTH))], work()),
        'e2e narrow': (lambda: [t[:, :1] for t in af.narrow_forward(
            fw, e2e_pad(af.NARROW))], work(ow=af.NARROW)),
        'e2e xT': (lambda: [t[:, :1] for t in af.xt_forward(
            fw, e2e_pad(af.NARROW).T.contiguous())], work()),
        'model path': (lambda: model(x, return_ue=True),
                       work(ow=fw.out_dim)),
    })
    flops16, moved16 = work(n_out=1)
    timed['packed bf16'] = (lambda: af.packed_forward(fw16, x_pad),
                            (flops16, moved16 - 2.0 * fw.w_all.numel()))
    for name, (run, (flops, moved)) in timed.items():
        t = event_ms(run, warmup, reps)
        bound_ms, bound_by = bound(
            flops, moved, card.bf16_flops if name == 'packed bf16'
            else card.flops, card.bytes)
        out['variants'][name] = dict(t, flops=flops, bytes=moved,
                                     bound_ms=bound_ms, bound_by=bound_by)
        emit(battery='forward', variant=name, rows=rows,
             ms=t['median_ms'], spread_pct=t['spread_pct'],
             bound_ms=bound_ms, bound_by=bound_by,
             share_of_bound=bound_ms / t['median_ms'],
             samples_per_s=rows / t['median_ms'] * 1e3, device=card.kind)
    v = {k: r['median_ms'] for k, r in out['variants'].items()}
    p = v['prod']
    deltas = {k: {'ms': v[k], 'delta_pct': 100.0 * (v[k] - p) / p}
              for k in ('io_floor', 'one_out', 'gemm_only', 'no_epi',
                        'xT input', 'xT+outT', 'narrow-both', 'packed',
                        'packed bf16', 'split (kernel 1)', 'e2e prod',
                        'model path')}
    members = {1: v['members=1'], 2: v['members=2'], 4: v['members=4'],
               M: p}
    member_fit = np.polyfit(list(members), list(members.values()), 1)
    # a chain cut short ends on a 128-wide layer through the last-layer
    # path, tuned for few columns: the depth sweep is not a line, so it is
    # reported as measured
    out['decomposition'] = {
        'prod_ms': p, 'vs_prod': deltas, 'members_ms': members,
        'ms_per_member': float(member_fit[0]),
        'ms_at_zero_members': float(member_fit[1]),
        'layers_ms': {1: v['layers=1'], 3: v['layers=3'],
                      5: v['layers=5'], L: p}}
    emit(battery='forward', decomposition=out['decomposition'], rows=rows,
         nvidia_smi=card.smi,
         clocks_power=nvidia_smi('clocks.sm,power.draw,temperature.gpu'))
    return out


# ---------------------------------------------------------------------------
# kernel 3
# ---------------------------------------------------------------------------
def flip_reach(plan, flips):
    """The elements of the flat ``(total_rows, 128)`` buffers that a ReLU
    decision taken one way by the kernel and the other by the plain version
    can move in that step, from ``flips`` ``(M, n_bn, B, 128)``: the
    flipped block's column (its W column, bias, BatchNorm scale and shift),
    and every row of the member's earlier blocks, which the backward
    reaches through ``d W^T``. The forward moves only by the flipped value,
    which is within rounding of 0."""
    reach = torch.zeros((plan.num_members, plan.slab_rows, ft.LANES),
                        dtype=torch.bool, device=flips.device)
    for L in plan.lins:
        if not L.relu:
            continue
        cols = flips[:, L.zh_idx].any(dim=1)                 # (M, 128)
        rows = list(range(L.w_off, L.w_off + L.in_rows)) + [
            L.b_off, L.g_off, L.be_off]
        reach[:, rows] |= cols[:, None, :]
        reach[:, :L.w_off] |= cols.any(dim=1)[:, None, None]
    return reach.reshape(plan.total_rows, ft.LANES)


def stepwise_vs_plain(plan, bufs, xs, ys, lr, step0, seed, drops,
                      epoch=None):
    """The training kernel against its plain version one step at a time,
    each step from the plain version's state, with both versions' ReLU
    decisions recorded and the l1 loss's sign decisions read from the
    output bias (``loss_flips``). Raises unless every element of theta, m
    and v that differs by more than TOL_TRAIN lies in the reach of a
    decision the two took differently (``flip_reach``; a flipped loss
    decision reaches its whole member), sigma and the losses agree
    everywhere, and loss decisions flipped on at most one step in
    LOSS_FLIP_STEPS. Returns the counts and the largest errors, in and
    outside that reach. ``epoch`` is the kernel held (default
    ``ft.fused_epoch``; the probe's prod through :func:`probe_prod`). A
    bf16-mixed plan is held to the bf16 bars instead
    (:func:`stepwise_vs_plain_bf16`)."""
    if plan.bf16:
        return stepwise_vs_plain_bf16(plan, bufs, xs, ys, lr, step0, seed,
                                      drops)
    epoch = epoch or ft.fused_epoch
    state = [b.clone() for b in bufs]
    shape = (1, plan.num_members, plan.n_bn, plan.batch, ft.LANES)
    out = {'steps': xs.shape[0], 'decisions_per_step': int(np.prod(shape)),
           'flips': 0, 'steps_with_flips': 0, 'loss_flips': 0,
           'steps_with_loss_flips': 0, 'over_tol': 0,
           'over_tol_outside_reach': 0, 'reach_share_max': 0.0,
           'max_abs_err_outside_reach': dict.fromkeys(TOL_TRAIN, 0.0),
           'max_abs_err_in_reach': dict.fromkeys(('theta', 'm', 'v'), 0.0)}
    for i in range(xs.shape[0]):
        signs = [torch.zeros(shape, dtype=torch.uint8, device=xs.device)
                 for _ in range(2)]
        # one step alone: its dropout salt (seed + i * SALT_STEP) and its
        # Adam count as inside the epoch
        args = (xs[i:i + 1], ys[i:i + 1], lr, step0 + i,
                (seed + i * ft.SALT_STEP) & 0xFFFFFFFF, drops)
        got = epoch(plan, *[b.clone() for b in state], *args,
                    signs=signs[0])
        want = ft.fused_epoch_reference(plan, *[b.clone() for b in state],
                                        *args, signs=signs[1])
        flips = (signs[0] != signs[1])[0]
        n_flips = int(flips.sum())
        out['flips'] += n_flips
        out['steps_with_flips'] += int(n_flips > 0)
        reach = flip_reach(plan, flips)
        flipped = loss_flips(plan, state[1], got[1], want[1])
        out['loss_flips'] += int(flipped.sum())
        out['steps_with_loss_flips'] += int(bool(flipped.any()))
        reach.view(plan.num_members, -1)[flipped] = True
        out['reach_share_max'] = max(out['reach_share_max'],
                                     float(reach.float().mean()))
        for name, g, w in zip(TOL_TRAIN, got, want):
            check(bool(torch.isfinite(g).all()),
                  f'fused_train step {i} {name}: non-finite values')
            err = (g - w).abs()
            inside = reach if name in ('theta', 'm', 'v') else \
                torch.zeros_like(err, dtype=torch.bool)
            over = err > TOL_TRAIN[name]
            out['over_tol'] += int(over.sum())
            out['over_tol_outside_reach'] += int((over & ~inside).sum())
            outside_err = float(torch.where(inside, 0.0, err).max())
            out['max_abs_err_outside_reach'][name] = max(
                out['max_abs_err_outside_reach'][name], outside_err)
            if name in out['max_abs_err_in_reach']:
                out['max_abs_err_in_reach'][name] = max(
                    out['max_abs_err_in_reach'][name],
                    float(torch.where(inside, err, 0.0).max()))
        state = list(want[:4])
    check(out['over_tol_outside_reach'] == 0,
          f'fused_train: {out["over_tol_outside_reach"]} values off by more '
          f'than {TOL_TRAIN} outside the reach of a ReLU or loss flip: {out}')
    check(out['steps_with_loss_flips']
          <= max(1, out['steps'] // LOSS_FLIP_STEPS),
          f'fused_train: l1 loss decisions flipped on '
          f'{out["steps_with_loss_flips"]} of {out["steps"]} steps: {out}')
    return out


def probe_prod(plan, theta, m, v, sigma, xs, ys, lr, step0, seed=0,
               drops=None, signs=None):
    """The probe's prod (``ablate_epoch``, kernel 3's one-block form) with
    :func:`~.ops.fused_train.fused_epoch`'s arguments, for
    :func:`stepwise_vs_plain`: the probe runs no dropout and always the
    joint mean, so ``plan`` must too, and ``seed`` and ``drops`` are
    unused."""
    check(plan.n_drop == 0 and not plan.per_member,
          'probe_prod: a plan with dropout or a per-member loss')
    return ae.ablate_epoch(plan, theta, m, v, sigma, xs, ys, lr, step0,
                           signs=signs)


def adam_v_error(plan, m0, v0, m1, v1):
    """The largest error of ``v1`` against Adam's update of ``v0`` with
    the clipped gradient that ``m1`` reveals, ``g = (m1 - b1 m0) / (1 -
    b1)``, in units of its fp32 round-off bound (both moments rounded at
    each op, the gradient's recovery carried through ``g^2``)."""
    m0, v0, m1, v1 = (t.double() for t in (m0, v0, m1, v1))
    eps = float(np.finfo(np.float32).eps)
    b1, b2 = float(np.float32(plan.b1)), float(np.float32(plan.b2))
    c1, c2 = float(np.float32(1 - plan.b1)), float(np.float32(1 - plan.b2))
    g = (m1 - b1 * m0) / c1
    eg = eps * (b1 * m0.abs() + m1.abs() + c1 * g.abs()) / c1
    want = b2 * v0 + c2 * g * g
    bound = eps * (b2 * v0 + 2 * c2 * g * g) + c2 * eg * (2 * g.abs() + eg)
    return float(((v1 - want).abs() / bound.clamp_min(1e-45)).max())


def loss_flips(plan, m0, got_m, want_m):
    """``(M,)`` bool: the members whose l1 loss took a sign decision one way
    in ``got_m``'s step and the other in ``want_m``'s. The output layer's
    bias gradient is the sum over the batch of the loss gradient, +-c a
    row: summed in any order it is exact to round-off, and one row's
    decision the other way moves it by 2c, at least 2 / batch of it. So a
    member flipped where the gradient that m reveals there, ``(m - b1 m0)
    / (1 - b1)``, differs by more than LOSS_FLIP_SHARE of its size. A
    flipped decision moves every gradient of the member (and, under the
    joint mean, of every member), like a ReLU flip of the output."""
    M = plan.num_members
    if plan.loss != 'l1_loss':
        return torch.zeros(M, dtype=torch.bool, device=m0.device)
    L = plan.lins[-1]
    rows = [i * plan.slab_rows + L.b_off for i in range(M)]
    eps = float(np.finfo(np.float32).eps)
    b1, c1 = float(np.float32(plan.b1)), float(np.float32(1 - plan.b1))
    m0, got_m, want_m = (t[rows, :L.out_w].double()
                         for t in (m0, got_m, want_m))
    g = [(t - b1 * m0) / c1 for t in (got_m, want_m)]
    # the recovery's own round-off, as in adam_v_error, for both
    eg = eps * (2 * b1 * m0.abs() + got_m.abs() + want_m.abs()
                + c1 * (g[0].abs() + g[1].abs())) / c1
    return ((g[0] - g[1]).abs() > LOSS_FLIP_SHARE * g[1].abs()
            + 8 * eg).any(dim=1)


def tensor_core_products(plan, a, b):
    """``a @ b`` in ``plan``'s form, summed another way than
    :func:`~.ops.fused_train._mm` sums it: in bf16-mixed, both operands
    rounded to bf16 and their products summed into fp32 by cuBLAS's bf16
    tensor-core GEMM on the card (``torch.mm(..., out_dtype=float32)``),
    the hardware kernel 3b's ``mma.sync`` sums on; on the CPU, which has
    no such GEMM, summed exactly in float64 and rounded to fp32. An fp32
    plan's product is ``a @ b``."""
    if not plan.bf16:
        return a @ b
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a.device.type == 'cuda':
        return torch.mm(a, b, out_dtype=torch.float32)
    return (a.double() @ b.double()).float()


def stepwise_vs_plain_bf16(plan, bufs, xs, ys, lr, step0, seed, drops,
                           gate=True, on_step=None, epoch=None,
                           witnessed=False):
    """Kernel 3's bf16 form against its plain version one step at a time,
    each step from the plain bf16 version's state, beside the plain fp32
    step from the same state for the bf16-vs-fp32 gap. Both bf16 versions
    record their ReLU decisions, and the l1 loss's sign decisions show in
    the output bias (``loss_flips``). Each step's sigma, and outside the
    reach of a decision the two took differently (a flipped loss decision
    reaches its whole member), its m and each parameter's change in the
    step, are held to the bf16 bars (``bf16_close``) against the step's
    bf16-vs-fp32 gap (under a clip the l1 decisions are read from an
    unclipped launch of both on the same state as well, since the clip's
    rescaling can hide a flip in the output bias); v, everywhere, to
    Adam's update of the gradient m
    reveals (TOL_ADAM_V); the per-step losses, one value a step, as one
    curve at the end, with the plain bf16 epoch on the host as the witness
    of two correct bf16 versions (BF16_WITNESS_SHARE). A bf16 rounding
    that goes the other way moves values by whole bf16 units, so the bars
    are on the gap, not on fp32 round-off.

    Each step also records how far two more correct bf16 steps part from
    the card's plain step, on the same elements and the same scale: the
    host's plain step (``host_*``) and the plain step with its products
    summed on the tensor cores (``witness_*``,
    :func:`tensor_core_products`). With ``witnessed`` (for networks whose
    BatchNorm shifts keep every ReLU on one side, ``separate_relu``, where
    correct versions part by up to the whole gap on single steps) a step's
    bars are widened to BF16_WITNESS_SHARE times the larger of those two
    shares on that step; a step past them is an excursion, held within
    BF16_WITNESS_SHARE times the gap's own rms and max (or the witnesses'
    shares, where larger), and the excursions may number at most
    BF16_WITNESS_SHARE times the steps on which a witness goes past the
    per-step bars itself (at least one such step is counted).

    Raises at the first bar passed; with ``gate`` False it runs every step
    and lists the bars passed under ``failures`` (and the first such step
    under ``first_failed_step``). ``on_step`` receives each step's record
    (flips, loss flips, v's error, each buffer's error shares and those of
    the two witnesses, whether it was an excursion, the bars it passed).
    ``epoch`` is the kernel held (default ``ft.fused_epoch``). Returns the
    counts, each buffer's largest error and error shares, and the
    excursions (``excursions``: the steps, the allowance, the steps each
    witness spent past the per-step bars)."""
    epoch = epoch or ft.fused_epoch
    plan32 = dataclasses.replace(plan, bf16=False)
    state = [b.clone() for b in bufs]
    shape = (1, plan.num_members, plan.n_bn, plan.batch, ft.LANES)
    shares = ('theta', 'm', 'v', 'sigma')
    out = {'steps': xs.shape[0], 'decisions_per_step': int(np.prod(shape)),
           'flips': 0, 'steps_with_flips': 0, 'loss_flips': 0,
           'steps_with_loss_flips': 0, 'steps_buffers_held': 0,
           'reach_share_max': 0.0,
           'max_abs_err': dict.fromkeys(TOL_TRAIN, 0.0),
           'rms_share_max': dict.fromkeys(shares, 0.0),
           'max_share_max': dict.fromkeys(shares, 0.0),
           'adam_v_err_max': 0.0, 'failures': [],
           'first_failed_step': None}
    gap_bars = {'rms_share': BF16_RMS_SHARE, 'max_share': BF16_MAX_SHARE}
    # clipping rescales the whole gradient by its global norm, which a
    # flipped l1 decision moves too, and in the output bias the two can
    # cancel (tools/bf16_mc_stepwise.py --inspect), so the l1 decisions
    # are also read from an unclipped step
    unclipped = (dataclasses.replace(plan, clip=None)
                 if plan.loss == 'l1_loss' and plan.clip is not None
                 else None)
    excursions = {'steps': 0, 'witnessed': witnessed,
                  'witness_steps_over': {'host': 0, 'witness': 0}}

    def bar(step, ok, msg, record):
        if ok:
            return
        check(not gate, msg)
        record['failed'].append(msg)
        out['failures'].append(msg)
        if out['first_failed_step'] is None:
            out['first_failed_step'] = step

    curve = ([], [], [], [])
    host = [b.cpu() for b in (xs, ys)]
    host_drops = None if drops is None else drops.cpu()
    for i in range(xs.shape[0]):
        signs = [torch.zeros(shape, dtype=torch.uint8, device=xs.device)
                 for _ in range(2)]
        rest = (lr, step0 + i, (seed + i * ft.SALT_STEP) & 0xFFFFFFFF)
        args = (xs[i:i + 1], ys[i:i + 1], *rest, drops)
        got = epoch(plan, *[b.clone() for b in state], *args,
                    signs=signs[0])
        want = ft.fused_epoch_reference(plan, *[b.clone() for b in state],
                                        *args, signs=signs[1])
        ref32 = ft.fused_epoch_reference(plan32,
                                         *[b.clone() for b in state], *args)
        host_out = ft.fused_epoch_reference(
            plan, *[b.to('cpu', copy=True) for b in state], host[0][i:i + 1],
            host[1][i:i + 1], *rest, host_drops)
        tensor_cores = ft.fused_epoch_reference(
            plan, *[b.clone() for b in state], *args,
            products=tensor_core_products)
        flips = (signs[0] != signs[1])[0]
        n_flips = int(flips.sum())
        out['flips'] += n_flips
        out['steps_with_flips'] += int(n_flips > 0)
        outside = ~flip_reach(plan, flips)
        flipped = loss_flips(plan, state[1], got[1], want[1])
        if unclipped is not None:
            flipped |= loss_flips(
                unclipped, state[1],
                epoch(unclipped, *[b.clone() for b in state], *args)[1],
                ft.fused_epoch_reference(unclipped,
                                         *[b.clone() for b in state],
                                         *args)[1])
        out['loss_flips'] += int(flipped.sum())
        out['steps_with_loss_flips'] += int(bool(flipped.any()))
        outside.view(plan.num_members, -1)[flipped] = False
        out['steps_buffers_held'] += int(bool(outside.any()))
        reach = 1.0 - float(outside.float().mean())
        out['reach_share_max'] = max(out['reach_share_max'], reach)
        v_err = adam_v_error(plan, state[1], state[2], got[1], got[2])
        out['adam_v_err_max'] = max(out['adam_v_err_max'], v_err)
        record = {'step': i, 'flips': n_flips,
                  'loss_flips': int(flipped.sum()), 'reach_share': reach,
                  'adam_v_err': v_err, 'rms_share': {}, 'max_share': {},
                  'witness_rms_share': {}, 'witness_max_share': {},
                  'host_rms_share': {}, 'host_max_share': {},
                  'excursion': False, 'failed': []}
        bar(i, v_err <= TOL_ADAM_V,
            f'fused_train_bf16 step {i} v: {v_err:.2f} round-off bounds '
            f'from Adam\'s update of the gradient m reveals', record)
        over = {'host': False, 'witness': False}
        for j, name in enumerate(TOL_TRAIN):
            g, w, r = got[j], want[j], ref32[j]
            check(bool(torch.isfinite(g).all()),
                  f'fused_train_bf16 step {i} {name}: non-finite values')
            if name == 'losses':
                for c, t in zip(curve, (g, w, r, host_out[4])):
                    c.append(t)
                continue
            h, tc = host_out[j].to(w.device), tensor_cores[j]
            if name == 'theta':          # the change the step made
                g, w, r, h, tc = (t - state[0] for t in (g, w, r, h, tc))
            if name in ('theta', 'm', 'v'):
                if not bool(outside.any()):      # all within a flip's reach
                    continue
                g, w, r, h, tc = (t[outside] for t in (g, w, r, h, tc))
            label = f'fused_train_bf16 step {i} {name}'
            res = bf16_close(label, g, w, r, gate=False)
            err = res['max_abs_err']
            record['rms_share'][name] = (res['rms_err']
                                         / max(res['gap_rms'], 1e-30))
            record['max_share'][name] = err / max(res['gap_max'], 1e-30)
            for key, other in (('witness', tc), ('host', h)):
                apart = (other - w).double()
                record[key + '_rms_share'][name] = float(
                    apart.square().mean().sqrt()) / max(res['gap_rms'], 1e-30)
                record[key + '_max_share'][name] = float(
                    apart.abs().max()) / max(res['gap_max'], 1e-30)
                over[key] |= name != 'v' and any(
                    record[f'{key}_{k}'][name] > b
                    for k, b in gap_bars.items())
            for key in ('rms_share', 'max_share'):
                out[key + '_max'][name] = max(out[key + '_max'][name],
                                              record[key][name])
            out['max_abs_err'][name] = max(out['max_abs_err'][name], err)
            if name == 'v':      # v's gate is the Adam update above
                continue
            if not witnessed:
                verdict = bf16_verdict(label, res)
                bar(i, verdict is None, verdict, record)
                continue
            for key, share in gap_bars.items():
                apart = max(record['witness_' + key][name],
                            record['host_' + key][name])
                kernel = record[key][name]
                if kernel <= max(share, BF16_WITNESS_SHARE * apart):
                    continue
                record['excursion'] = True
                limit = BF16_WITNESS_SHARE * max(1.0, apart)
                bar(i, kernel <= limit,
                    f'{label}: {key.replace("_", " ")} of the gap '
                    f'{kernel:.3f}, past an excursion\'s bar {limit:.3f} '
                    f'(the witnesses\' {apart:.3f})', record)
        for key, past in over.items():
            excursions['witness_steps_over'][key] += int(past)
        excursions['steps'] += int(record['excursion'])
        if on_step is not None:
            on_step(record)
        state = list(want[:4])
    allowed = BF16_WITNESS_SHARE * max(
        1, *excursions['witness_steps_over'].values())
    excursions['allowed'] = allowed
    out['excursions'] = excursions
    if witnessed:
        bar(xs.shape[0], excursions['steps'] <= allowed,
            f'fused_train_bf16: {excursions["steps"]} excursions past the '
            f'per-step bars, more than {allowed:g} ({BF16_WITNESS_SHARE:g} x '
            f'the steps a witness went past them: '
            f'{excursions["witness_steps_over"]})', {'failed': []})
    res = bf16_close('fused_train_bf16 losses',
                     *(torch.cat(c) for c in curve[:3]),
                     witness=torch.cat(curve[3]), gate=False)
    verdict = bf16_verdict('fused_train_bf16 losses', res)
    bar(xs.shape[0], verdict is None, verdict, {'failed': []})
    out['max_abs_err']['losses'] = res['max_abs_err']
    out['losses'] = res
    return out


def train_problem(seed, device, batch=BATCH, steps=STEPS, separate=False,
                  clip=CLIP, bf16=False):
    """The flagship's plan (its bf16-mixed form with ``bf16``) and buffers
    for ``steps`` batches of ``batch`` rows, clipped at ``clip``:
    parameters from the builder (BatchNorm shifted off 0 with
    ``separate``), Adam moments drawn small and non-zero, and rows of 5
    normal features with a smooth target, padded as the trainer pads them.
    (From zero moments, Adam moves a BatchNorm-cancelled Linear bias by
    about lr a step on the sign of a rounding-level gradient, so two
    correct implementations part there at once.)"""
    model = flagship(seed, device)
    if separate:
        separate_relu(model, torch.Generator().manual_seed(seed + 1))
    plan = ft.plan_fused_train(model.net, MEMBERS, batch, loss='l1_loss',
                               clip=clip, bf16=bf16)
    params, state = tensor_trees(model.net)
    theta = ft.pack_tree(plan, params, device)
    rng = np.random.default_rng(seed + 2)
    x = rng.normal(size=(steps * batch, IN_DIM)).astype(np.float32)
    y = (np.sin(x[:, :1]) + 0.5 * x[:, 1:2] * x[:, 2:3]
         - 0.3 * x[:, 4:5]).astype(np.float32)
    xs, ys = ft.gather_epoch_batches(
        plan, torch.as_tensor(x, device=device),
        torch.as_tensor(y, device=device),
        torch.arange(steps * batch, device=device))
    def moments(draw):            # in the parameters' shapes: padding stays 0
        return ft.pack_tree(plan, [
            {k: torch.as_tensor(draw(tuple(v.shape)), dtype=torch.float32)
             for k, v in layer.items()} for layer in params], device)
    bufs = [theta, moments(lambda shape: rng.normal(size=shape) * 1e-3),
            moments(lambda shape: rng.uniform(1e-8, 1e-6, size=shape)),
            ft.pack_state(plan, state, device)]
    return model, plan, bufs, xs, ys


# name: ablate_epoch keywords (opt_chunk in rows of 128, as the TPU probe's)
TRAIN_VARIANTS = {
    'prod': {},
    'no_opt': {'mode': 'no_opt'},
    'no_bwd': {'mode': 'no_bwd'},
    'fwd1': {'mode': 'fwd1'},
    'empty': {'mode': 'empty'},
    'unroll2': {'unroll': 2},
    'unroll4': {'unroll': 4},
    'gn_fused': {'gn_fused': True},
    'ch4096': {'opt_chunk': 4096},
    'ch8': {'opt_chunk': 8},
    'unroll4+gn+ch4096': {'unroll': 4, 'gn_fused': True, 'opt_chunk': 4096},
}


def _train_work(plan, steps, mode):
    """(FLOP, bytes) of one ablated epoch: the GEMMs the mode runs, and its
    buffers read once and written once."""
    R, G = plan.total_rows * ft.LANES, plan.total_sig_rows * ft.LANES
    M = plan.num_members
    batches = steps * plan.batch * (plan.in_pad + plan.out_pad)
    fwd = 2.0 * steps * plan.batch * plan.macs_per_row()
    if mode == 'empty':
        return 0.0, 4.0 * 2 * steps
    if mode == 'fwd1':
        return fwd, 4.0 * (R / M + 2 * G / M + batches + steps)
    if mode == 'no_bwd':
        return fwd * M, 4.0 * (R + 2 * G + batches + steps)
    flops = train_flops(plan, steps)
    if mode == 'no_opt':
        return flops, 4.0 * (R + 2 * G + batches + steps)
    return flops, 4.0 * (2 * 3 * R + 2 * G + batches + steps)


def _train_gate(card, name, plan, bufs, xs, ys, kw):
    """``ablate_epoch`` with the keywords ``kw`` against its plain version
    from the same buffers (TOL_PROBE for gn_fused and opt_chunk, else
    TOL_TRAIN); in the modes with a gradient, each step's global gradient
    norm too, to TOL_NORM, with the steps on which the clip bound. Prints
    and returns the gate's record."""
    S = xs.shape[0]
    graded = kw.get('mode', 'prod') in ('prod', 'no_opt')
    norms = [torch.empty(S, device=card.device) if graded else None
             for _ in range(2)]
    got, want = (fn(plan, *[b.clone() for b in bufs], xs, ys, LR, 0,
                    norms=n, **kw)
                 for fn, n in zip((ae.ablate_epoch, ae.ablate_epoch_reference),
                                  norms))
    tol = TOL_PROBE if kw.get('gn_fused') or kw.get('opt_chunk') \
        else TOL_TRAIN
    rec = {'max_abs_err': {
        k: _close(f'ablate_epoch {name} {k}', g, w,
                  {'rtol': 0.0, 'atol': tol[k]})
        for k, g, w in zip(TOL_TRAIN, got, want)}}
    if graded:
        _close(f'ablate_epoch {name} grad norm', norms[0], norms[1], TOL_NORM)
        rec.update(
            grad_norm_rel_err=float(((norms[0] - norms[1]).abs()
                                     / norms[1]).max()),
            grad_norm=[float(norms[1].min()), float(norms[1].max())],
            clip=plan.clip, clip_binds_steps=int(
                (torch.minimum(*norms) >= plan.clip).sum()))
    emit(battery='train', gate=name, steps=S, batch=plan.batch,
         device=card.kind, max_abs_err_vs_plain=rec['max_abs_err'],
         tol={k: tol[k] for k in TOL_TRAIN},
         **{k: v for k, v in rec.items() if k != 'max_abs_err'})
    return rec


def _equal_runs(name, first, again):
    for k, g, w in zip(TOL_TRAIN, first, again):
        _equal(f'{name} {k}', g, w)


def train_battery(device='cuda', seed=0, steps=None, reps=5, bf16=False):
    """Gate and time kernel 3 and its probe on the flagship, ``steps``
    steps of batch 128 an epoch (default 500 on the card). The probe's
    variants (``ablate_epoch``: the one-block form of the step, carved)
    are held to their plain versions and timed beside the production
    kernel (the cluster form, ``library fused_epoch``), which is held step
    by step to its plain version at every batch of the batch scaling and
    timed there too. With ``bf16`` the battery runs kernel 3's bf16 form
    (the probe is fp32 only): its step-by-step gates at every batch, its
    timed epoch (``library fused_epoch``) and its batch scaling. Returns
    ``{'gates': {...}, 'variants': {name: {...}}, 'budget': {...},
    'batch_scaling': {...}, 'batch_scaling_probe': {...}}``; prints each
    as a JSON line."""
    card = _Card(resolve_device(device))
    dev = card.device
    steps = steps or (STEPS if card.on_card else CPU_STEPS)
    gates = {}
    if not bf16:
        # gates: every variant against the plain version on a network whose
        # pre-ReLU values sit away from 0, over GATE_STEPS steps; gn_fused
        # again with a clip that binds on every step, so that the clip scale
        # carries its sum of squares
        _, gplan, gbufs, gxs, gys = train_problem(seed, dev,
                                                  steps=GATE_STEPS,
                                                  separate=True)
        gates = {name: _train_gate(card, name, gplan, gbufs, gxs, gys, kw)
                 for name, kw in TRAIN_VARIANTS.items()}
        name = f'gn_fused clip={BINDING_CLIP:g}'
        gates[name] = _train_gate(card, name, *train_problem(
            seed, dev, steps=GATE_STEPS, separate=True, clip=BINDING_CLIP)[1:],
            {'gn_fused': True})
        check(gates[name]['clip_binds_steps'] == GATE_STEPS,
              f'{name}: the clip bound on only '
              f'{gates[name]["clip_binds_steps"]} of {GATE_STEPS} steps')
    # at each batch of the batch scaling: kernel 3 (its bf16 form with
    # bf16) and the probe's prod (the one-block form; the two no longer
    # share code) each held to the plain epoch one step at a time, where a
    # value past TOL_TRAIN must lie in the reach of a ReLU or loss
    # decision the two took differently (at these batches a separate_relu
    # network too can put a pre-ReLU value within rounding of 0), and the
    # probe's prod bit for bit with the same bodies replayed as a CUDA
    # graph
    # (the bf16 form step by step on the flagship as built, as the card
    # tests hold it: its bars attribute the flipped decisions)
    form = 'kernel 3b' if bf16 else 'kernel 3'
    for b in BATCHES:
        name = f'{form} B={b}'
        _, bplan, bbufs, bxs, bys = train_problem(
            seed, dev, batch=b, steps=GATE_STEPS, separate=not bf16,
            bf16=bf16)
        rec = {'stepwise': stepwise_vs_plain(bplan, bbufs, bxs, bys, LR, 0,
                                             0, None)}
        if not bf16:
            rec['probe_prod_stepwise'] = stepwise_vs_plain(
                bplan, bbufs, bxs, bys, LR, 0, 0, None, epoch=probe_prod)
            _equal_runs(f'ablate_epoch prod B={b}', *(
                ae.ablate_epoch(bplan, *[t.clone() for t in bbufs], bxs, bys,
                                LR, 0, unroll=u) for u in (1, 2)))
            rec['probe_prod_bit_for_bit_with_its_graph'] = True
        gates[name] = rec
        emit(battery='train', gate=name, steps=GATE_STEPS, batch=b,
             device=card.kind, **{k: v for k, v in rec.items()})
    # at the timed length, on the flagship as built: kernel 3 and the
    # probe's prod each twice from the same buffers, bit for bit (fixed
    # summation orders, no float atomics), and each timed unroll and
    # opt_chunk against the run without them (they change how the probe
    # runs, not its sums), bit for bit
    model, plan, bufs, xs, ys = train_problem(seed, dev, steps=steps,
                                              bf16=bf16)

    def epoch(fn=ae.ablate_epoch, **kw):
        return fn(plan, *[b.clone() for b in bufs], xs, ys, LR, 0, **kw)

    _equal_runs(f'{form} repeat', epoch(ft.fused_epoch),
                epoch(ft.fused_epoch))
    gates[f'{form} repeat'] = {'steps': steps, 'bit_for_bit': True}
    emit(battery='train', gate=f'{form} repeat', steps=steps,
         bit_for_bit=True, device=card.kind)
    if not bf16:
        runs = {False: epoch()}
        _equal_runs('ablate_epoch prod repeat', runs[False], epoch())
        gates['prod repeat'] = {'steps': steps, 'bit_for_bit': True}
        emit(battery='train', gate='prod repeat', steps=steps,
             bit_for_bit=True, device=card.kind)
        for name, kw in TRAIN_VARIANTS.items():
            if 'unroll' not in kw and 'opt_chunk' not in kw:
                continue
            fused = kw.get('gn_fused', False)
            if fused not in runs:
                runs[fused] = epoch(gn_fused=True)
            _equal_runs(f'ablate_epoch {name}', epoch(**kw), runs[fused])
            against = 'gn_fused' if fused else 'prod'
            gates[f'{name}_vs_{against}'] = {'steps': steps,
                                             'bit_for_bit': True}
            emit(battery='train', gate=f'{name}_vs_{against}', steps=steps,
                 bit_for_bit=True, device=card.kind)
    out = {'gates': gates, 'variants': {}, 'budget': {}, 'batch_scaling': {},
           'batch_scaling_probe': {}}
    if not card.on_card:
        emit(battery='train', device='cpu', steps=steps, bf16=bf16,
             note='plain versions only: no device time on the CPU')
        return out

    rows = steps * plan.batch

    def record(name, run, work, plan_=plan):
        peak, extra_s = card.flops, 0.0
        if plan_.bf16:     # products at the bf16 peak, the rest fp32
            peak = card.bf16_flops
            extra_s = train_rest_flops(plan_, steps) / card.flops
        t = event_ms(run, 1, reps)
        bound_ms, bound_by = bound(*work, peak, card.bytes, extra_s=extra_s)
        ms = t['median_ms']
        emit(battery='train', variant=name, batch=plan_.batch, steps=steps,
             bf16=plan_.bf16, ms=ms, spread_pct=t['spread_pct'],
             us_per_step=1e3 * ms / steps,
             rows_per_s=steps * plan_.batch / ms * 1e3, bound_ms=bound_ms,
             bound_by=bound_by, share_of_bound=bound_ms / ms,
             device=card.kind)
        return dict(t, flops=work[0], bytes=work[1], bound_ms=bound_ms,
                    bound_by=bound_by, us_per_step=1e3 * ms / steps)

    # kernel 3 (the cluster form) and the probe's one-block prod in turns
    kernel = lambda: ft.fused_epoch(plan, *bufs, xs, ys, LR, 0)  # noqa: E731
    out['variants']['library fused_epoch'] = record(
        'library fused_epoch', kernel, _train_work(plan, steps, 'prod'))
    if not bf16:
        for name, kw in TRAIN_VARIANTS.items():
            out['variants'][name] = record(
                name, lambda kw=kw: ae.ablate_epoch(plan, *bufs, xs, ys, LR,
                                                    0, **kw),
                _train_work(plan, steps, kw.get('mode', 'prod')))
        out['variants']['library fused_epoch again'] = record(
            'library fused_epoch again', kernel,
            _train_work(plan, steps, 'prod'))
        us = {k: r['us_per_step'] for k, r in out['variants'].items()}
        p = us['prod']
        out['budget'] = {
            'prod_us_per_step': p,
            'kernel_3_us_per_step': min(us['library fused_epoch'],
                                        us['library fused_epoch again']),
            'launch_floor_us': us['empty'],
            'one_member_forward_us': us['fwd1'] - us['empty'],
            'loss_sweep_us': us['no_bwd'],
            'backward_us': us['no_opt'] - us['no_bwd'],
            'optimizer_us': p - us['no_opt'],
            'graph_saves_us': {k: p - us[k] for k in ('unroll2', 'unroll4')},
            'share_of_prod': {k: us[k] / p for k in
                              ('empty', 'fwd1', 'no_bwd', 'no_opt')}}
        emit(battery='train', budget=out['budget'], steps=steps, rows=rows,
             nvidia_smi=card.smi,
             clocks_power=nvidia_smi('clocks.sm,power.draw,temperature.gpu'))
    for b in BATCHES:
        _, bplan, bbufs, bxs, bys = train_problem(seed, dev, batch=b,
                                                  steps=steps, bf16=bf16)
        work = _train_work(bplan, steps, 'prod')
        out['batch_scaling'][b] = record(
            f'{form} B={b}',
            lambda: ft.fused_epoch(bplan, *bbufs, bxs, bys, LR, 0), work,
            plan_=bplan)
        if not bf16:
            out['batch_scaling_probe'][b] = record(
                f'prod B={b}',
                lambda: ae.ablate_epoch(bplan, *bbufs, bxs, bys, LR, 0),
                work, plan_=bplan)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('battery', choices=('forward', 'train'))
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu': the plain "
                             'versions, gates only')
    parser.add_argument('--rows', type=int, default=None,
                        help=f'forward: rows (default {ROWS:,} on the card, '
                             f'{CPU_ROWS} on the CPU)')
    parser.add_argument('--steps', type=int, default=None,
                        help=f'train: steps an epoch (default {STEPS} on '
                             f'the card, {CPU_STEPS} on the CPU)')
    parser.add_argument('--reps', type=int, default=None,
                        help='timed passes (forward 10) or epochs (train 5)')
    parser.add_argument('--bf16', action='store_true',
                        help="train: kernel 3's bf16 form (its gates, "
                             'epoch and batch scaling; the probe is fp32)')
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False   # true fp32 plains
    if args.battery == 'forward':
        forward_battery(device, args.seed, args.rows, args.reps or 10)
    else:
        train_battery(device, args.seed, args.steps, args.reps or 5,
                      args.bf16)
    return 0


if __name__ == '__main__':
    sys.exit(main())
