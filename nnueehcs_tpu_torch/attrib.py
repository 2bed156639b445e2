"""Kernel attribution on the card: where the time of kernels 1 and 3 goes.

The batteries of the JAX package's TPU probes, ported to the card:
``experiments/grid_r5/attrib_eval.py`` and ``attrib_eval2.py`` and the fp32
variants of ``experiments/grid_r4/kernel_variants.py`` (``forward``: kernel
1, the fused ensemble pass) and ``experiments/grid_r5/attrib_train.py``
(``train``: kernel 3, the fused training epoch), on the flagship ensemble
built by this package's own builder (8 members, 5 inputs, 6 x [Linear 128 ->
BatchNorm1d -> ReLU], Linear 128 -> 1, weights from ``--seed``)::

    python -m nnueehcs_tpu_torch.attrib {forward,train} [--seed N]
        [--device cuda] [--rows N] [--steps N] [--reps N]

Each variant is first held to its plain PyTorch version on the same inputs
(and each form of the production math to the production kernel, bit for
bit), then timed: CUDA-event medians over ``--reps`` passes (or epochs)
after warm-ups, with the spread of the middle 60% and the variant's bound
(fp32 operations over the card's peak, or bytes over its memory rate). It
prints one JSON line per gate and per variant, then the decomposition
lines: kernel 1 against its ``prod`` control, and kernel 3's per-step
budget and its batch scaling. The TPU-only items of the probes are left
out: the tile sweeps (the CUDA block is 64 rows, fixed by the register
tiling) and the MXU identity transpose (the kernel writes feature-major
outputs directly).

It runs on the card unless ``--device cpu`` is given; there the kernels'
plain versions run, at small sizes, the gates only: a CPU time is no
measure of the card.
"""
from __future__ import annotations

import argparse
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
from .ops.fused_ensemble import fused_forward_prefolded, prepare_fused_weights

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
CLIP = 5.0                     # the flagship's gradient_clip_val
BINDING_CLIP = 1e-2            # below every step's gradient norm
# (name substring, fp32 non-tensor FLOP/s, memory bytes/s), NVIDIA data
# sheets at full power; the first match wins
PEAKS = [('H100 PCIe', 51.2e12, 2.0e12), ('H100 NVL', 60e12, 3.9e12),
         ('H200', 67e12, 4.8e12), ('H100', 67e12, 3.35e12)]


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


def bound(flops, moved, peak_flops, peak_bytes, exps=0, ex2_rate=1.0):
    """(bound_ms, bound_by): the largest of fp32 operations over the fp32
    peak, ``exps`` MUFU ex2 results over the ex2 rate, and bytes over the
    memory rate."""
    t_ops = max(flops / peak_flops, exps / ex2_rate)
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
    # production math against kernel 1 itself, bit for bit
    base = fused_forward_prefolded(fw, x)
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
                       'equals_kernel_1': prod_width is not None}
        emit(battery='forward', gate=name, device=card.kind,
             max_abs_err_vs_plain=errs,
             bit_for_bit_with_kernel_1=prod_width is not None)
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
    for name, (run, (flops, moved)) in timed.items():
        t = event_ms(run, warmup, reps)
        bound_ms, bound_by = bound(flops, moved, card.flops, card.bytes)
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
                        'split (kernel 1)', 'e2e prod', 'model path')}
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


def stepwise_vs_plain(plan, bufs, xs, ys, lr, step0, seed, drops):
    """The training kernel against its plain version one step at a time,
    each step from the plain version's state, with both versions' ReLU
    decisions recorded. Raises unless every element of theta, m and v that
    differs by more than TOL_TRAIN lies in the reach of a decision the two
    took differently (``flip_reach``), and sigma and the losses agree
    everywhere. Returns the counts and the largest errors, in and outside
    that reach."""
    state = [b.clone() for b in bufs]
    shape = (1, plan.num_members, plan.n_bn, plan.batch, ft.LANES)
    out = {'steps': xs.shape[0], 'decisions_per_step': int(np.prod(shape)),
           'flips': 0, 'steps_with_flips': 0, 'over_tol': 0,
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
        got = ft.fused_epoch(plan, *[b.clone() for b in state], *args,
                             signs=signs[0])
        want = ft.fused_epoch_reference(plan, *[b.clone() for b in state],
                                        *args, signs=signs[1])
        flips = (signs[0] != signs[1])[0]
        n_flips = int(flips.sum())
        out['flips'] += n_flips
        out['steps_with_flips'] += int(n_flips > 0)
        reach = flip_reach(plan, flips)
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
          f'than {TOL_TRAIN} outside the reach of a ReLU flip: {out}')
    return out


def train_problem(seed, device, batch=BATCH, steps=STEPS, separate=False,
                  clip=CLIP):
    """The flagship's plan and buffers for ``steps`` batches of ``batch``
    rows, clipped at ``clip``: parameters from the builder (BatchNorm
    shifted off 0 with ``separate``), Adam moments drawn small and
    non-zero, and rows of 5 normal features with a smooth target, padded
    as the trainer pads them.
    (From zero moments, Adam moves a BatchNorm-cancelled Linear bias by
    about lr a step on the sign of a rounding-level gradient, so two
    correct implementations part there at once.)"""
    model = flagship(seed, device)
    if separate:
        separate_relu(model, torch.Generator().manual_seed(seed + 1))
    plan = ft.plan_fused_train(model.net, MEMBERS, batch, loss='l1_loss',
                               clip=clip)
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


def train_battery(device='cuda', seed=0, steps=None, reps=5):
    """Gate and time kernel 3's probe on the flagship, ``steps`` steps of
    batch 128 an epoch (default 500 on the card). Returns ``{'gates':
    {...}, 'variants': {name: {...}}, 'budget': {...}, 'batch_scaling':
    {...}}``; prints each as a JSON line."""
    card = _Card(resolve_device(device))
    dev = card.device
    steps = steps or (STEPS if card.on_card else CPU_STEPS)
    # gates: every variant against the plain version on a network whose
    # pre-ReLU values sit away from 0, over GATE_STEPS steps; gn_fused again
    # with a clip that binds on every step, so that the clip scale carries
    # its sum of squares
    _, gplan, gbufs, gxs, gys = train_problem(seed, dev, steps=GATE_STEPS,
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
    # prod at each other batch that the batch scaling times: kernel 3 bit
    # for bit over GATE_STEPS steps, and kernel 3 held to its plain epoch
    # one step at a time. At these batches a separate_relu network too can
    # put a pre-ReLU value within rounding of 0, so a value past TOL_TRAIN
    # must lie in the reach of a ReLU decision the two took differently.
    for b in BATCHES:
        if b == BATCH:               # the prod gate above
            continue
        name = f'prod B={b}'
        _, bplan, bbufs, bxs, bys = train_problem(
            seed, dev, batch=b, steps=GATE_STEPS, separate=True)
        got, want = (fn(bplan, *[t.clone() for t in bbufs], bxs, bys, LR, 0)
                     for fn in (ae.ablate_epoch, ft.fused_epoch))
        for k, g, w in zip(TOL_TRAIN, got, want):
            _equal(f'ablate_epoch {name} {k}', g, w)
        steps_ = stepwise_vs_plain(bplan, bbufs, bxs, bys, LR, 0, 0, None)
        gates[name] = {'bit_for_bit_with_kernel_3': True, 'stepwise': steps_}
        emit(battery='train', gate=name, steps=GATE_STEPS, batch=b,
             device=card.kind, bit_for_bit_with_kernel_3=True,
             stepwise_vs_plain=steps_)
    # at the timed length, on the flagship as built: prod against kernel 3
    # itself, and each timed unroll and opt_chunk against the run without
    # them (they change how the kernel runs, not its sums), bit for bit
    model, plan, bufs, xs, ys = train_problem(seed, dev, steps=steps)

    def epoch(fn=ae.ablate_epoch, **kw):
        return fn(plan, *[b.clone() for b in bufs], xs, ys, LR, 0, **kw)

    runs = {False: epoch()}
    for k, g, w in zip(TOL_TRAIN, runs[False], epoch(ft.fused_epoch)):
        _equal(f'ablate_epoch prod {k}', g, w)
    gates['prod_vs_kernel_3'] = {'steps': steps, 'bit_for_bit': True}
    emit(battery='train', gate='prod_vs_kernel_3', steps=steps,
         bit_for_bit=True, device=card.kind)
    for name, kw in TRAIN_VARIANTS.items():
        if 'unroll' not in kw and 'opt_chunk' not in kw:
            continue
        fused = kw.get('gn_fused', False)
        if fused not in runs:
            runs[fused] = epoch(gn_fused=True)
        for k, g, w in zip(TOL_TRAIN, epoch(**kw), runs[fused]):
            _equal(f'ablate_epoch {name} {k}', g, w)
        against = 'gn_fused' if fused else 'prod'
        gates[f'{name}_vs_{against}'] = {'steps': steps, 'bit_for_bit': True}
        emit(battery='train', gate=f'{name}_vs_{against}', steps=steps,
             bit_for_bit=True, device=card.kind)
    out = {'gates': gates, 'variants': {}, 'budget': {}, 'batch_scaling': {}}
    if not card.on_card:
        emit(battery='train', device='cpu', steps=steps,
             note='plain versions only: no device time on the CPU')
        return out

    rows = steps * plan.batch

    def record(name, run, work, plan_=plan):
        t = event_ms(run, 1, reps)
        bound_ms, bound_by = bound(*work, card.flops, card.bytes)
        ms = t['median_ms']
        emit(battery='train', variant=name, batch=plan_.batch, steps=steps,
             ms=ms, spread_pct=t['spread_pct'], us_per_step=1e3 * ms / steps,
             rows_per_s=steps * plan_.batch / ms * 1e3, bound_ms=bound_ms,
             bound_by=bound_by, share_of_bound=bound_ms / ms,
             device=card.kind)
        return dict(t, flops=work[0], bytes=work[1], bound_ms=bound_ms,
                    bound_by=bound_by, us_per_step=1e3 * ms / steps)

    out['variants']['library fused_epoch'] = record(
        'library fused_epoch',
        lambda: ft.fused_epoch(plan, *bufs, xs, ys, LR, 0),
        _train_work(plan, steps, 'prod'))
    for name, kw in TRAIN_VARIANTS.items():
        out['variants'][name] = record(
            name, lambda kw=kw: ae.ablate_epoch(plan, *bufs, xs, ys, LR, 0,
                                                **kw),
            _train_work(plan, steps, kw.get('mode', 'prod')))
    us = {k: r['us_per_step'] for k, r in out['variants'].items()}
    p = us['prod']
    out['budget'] = {
        'prod_us_per_step': p,
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
                                                  steps=steps)
        out['batch_scaling'][b] = record(
            f'prod B={b}',
            lambda: ae.ablate_epoch(bplan, *bbufs, bxs, bys, LR, 0),
            _train_work(bplan, steps, 'prod'), plan_=bplan)
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
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False   # true fp32 plains
    if args.battery == 'forward':
        forward_battery(device, args.seed, args.rows, args.reps or 10)
    else:
        train_battery(device, args.seed, args.steps, args.reps or 5)
    return 0


if __name__ == '__main__':
    sys.exit(main())
