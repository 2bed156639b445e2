#!/usr/bin/env python3
"""Kernel 3's bf16 form, step by step, on MC-dropout networks, on one card:

    python3 tools/bf16_mc_stepwise.py [--seeds 0-3] [--steps 64]
        [--cases separate,separate_p0,randomized] [--plant lr|lr_step|gap]
        [--out build/bf16_mc_stepwise.jsonl]
    python3 tools/bf16_mc_stepwise.py --inspect SEED:CASE:STEP[,...]
        [--steps 64] [--repeats 20]

For each seed and case: the MC-dropout flagship as ``chip_smoke.py``
builds it (one net, 5 inputs, 7 Linear layers 128 wide, a Dropout of rate
0.1 before each of the five hidden Linears), its plan at batch 128, clip 5,
l1 loss, ``--steps`` batches of the smooth target and non-zero Adam
moments drawn from ``numpy.random.default_rng(seed)``; then
``attrib.stepwise_vs_plain_bf16`` at lr 1e-3 (``chip_smoke.py``'s
step-by-step cases), each step from the plain bf16 state. The cases:

- ``separate``: BatchNorm shifted to +-3 (``attrib.separate_relu``), so
  every pre-ReLU value sits away from 0;
- ``separate_p0``: the same network with every dropout rate 0 (the masks
  keep everything), which isolates the masks;
- ``randomized``: BatchNorm as ``chip_smoke.py``'s ``build_mc`` sets it
  (scale in [0.5, 1.5], shift near 0).

The ``separate`` cases are held with ``witnessed`` bars (each step's bars
widened by how far two more correct bf16 steps part from the card's plain
step on that step; the steps past them, excursions, capped in reach and
in number), ``randomized`` with the per-step bars, as ``chip_smoke.py``
holds each.

Each step's record goes to ``--out`` as one JSON line: the ReLU and loss
flips, v's error, each buffer's error shares of the bf16-vs-fp32 gap
(``rms_share``, ``max_share``), the same shares of the witness, the plain
step with its products summed on the tensor cores
(``attrib.tensor_core_products``; ``witness_rms_share``,
``witness_max_share``), and of the host's plain step (``host_*``),
whether it was an excursion, and the bars it passed. Standard output has
one JSON line per seed and case: the bars passed, the excursions against
their allowance, and per buffer and share the largest share and the steps
past the per-step bar (0.2 of the gap's rms, 1x its max) of the kernel,
of the witness and of the host.

The one-block form of the step (``ops/csrc/fused_train.cuh``) lives on
only in the attribution probe (``ablate_train.cu``), which is fp32 and
runs no dropout (its bf16 form left the repository when kernel 3 became
one thread-block cluster per member). For each seed the ``separate``
network is also held through it, in fp32 with its Dropout slots removed
(``ablate_epoch.probe_plan``), by ``attrib.stepwise_vs_plain``, beside
kernel 3 on the same plan.

``--inspect`` takes single steps apart instead (``inspect``): repeated
launches bit for bit, the ReLU and l1 decisions (the smallest margins,
the output bias's unclipped gradient in units of 1/batch, the flips read
with and without the clip), the unclipped gradient norms and where the
kernel's gradient parts from the plain step's most, each BatchNorm's
smallest batch variance, and per Linear block the kernel's, the
witnesses' and the gap's distances.

``--plant`` replaces kernel 3b by a faulty one (``planted_fault``), which
the bars must fail: ``lr``, every step launched at twice the learning
rate; ``lr_step``, step 17 alone at twice the learning rate; ``gap``, every
step's parameter change moved off the kernel's by half the step's
bf16-vs-fp32 gap.

Ends with the card's name and power limit. It needs a CUDA card.
"""
import argparse
import dataclasses
import json
import os
import sys

CASES = ('separate', 'separate_p0', 'randomized')
BUFFERS = ('theta', 'm', 'v', 'sigma')
LR = 1e-3


def seeds(text):
    lo, _, hi = text.partition('-')
    return list(range(int(lo), int(hi or lo) + 1))


def summarize(records, bars):
    """Per buffer and share (rms, max): the largest share of the kernel,
    of the witness and of the host's plain step, and the steps each of
    them spent past the per-step bar (``bars``)."""
    out = {'failed_steps': sum(bool(r['failed']) for r in records),
           'excursion_steps': sum(r['excursion'] for r in records)}
    for name in BUFFERS:
        for key in ('rms_share', 'max_share'):
            rows = [(r[key][name], r['witness_' + key][name],
                     r['host_' + key][name]) for r in records
                    if name in r[key]]
            out[f'{name}_{key}'] = {
                f'{who}_{stat}': (max((row[k] for row in rows), default=0.0)
                                  if stat == 'max' else
                                  sum(row[k] > bars[key] for row in rows))
                for k, who in enumerate(('kernel', 'witness', 'host'))
                for stat in ('max', 'steps_over')}
    return out


PLANTS = {'lr': (2.0, 0.0, None), 'lr_step': (2.0, 0.0, (17,)),
          'gap': (1.0, 0.5, None)}


def planted_fault(ft, lr_scale=1.0, gap_share=0.0, steps=None, first=0):
    """Kernel 3b with a fault on the steps numbered in ``steps`` (counted
    from ``first``; every step when None), called one step at a time as
    the step check calls it: launched at ``lr_scale`` times the learning
    rate, and the parameters it returns moved off by ``gap_share`` of the
    step's bf16-vs-fp32 gap (their distance to the plain fp32 step's)."""
    import dataclasses

    def epoch(plan, theta, m, v, sigma, xs, ys, lr, step0, seed=0,
              drops=None, signs=None):
        if steps is not None and step0 - first not in steps:
            return ft.fused_epoch(plan, theta, m, v, sigma, xs, ys, lr,
                                  step0, seed, drops, signs=signs)
        fp32 = ft.fused_epoch_reference(
            dataclasses.replace(plan, bf16=False), theta.clone(), m.clone(),
            v.clone(), sigma.clone(), xs, ys, lr, step0, seed, drops)[0]
        out = ft.fused_epoch(plan, theta, m, v, sigma, xs, ys,
                             lr_scale * lr, step0, seed, drops, signs=signs)
        theta += gap_share * (theta - fp32)
        return out
    return epoch


def build(cs, attrib, seed, case):
    import torch
    model = cs.build_mc(seed)
    if case != 'randomized':
        attrib.separate_relu(model, torch.Generator().manual_seed(seed + 7))
    return model


def problem(cs, attrib, ft, seed, case, steps):
    """The network, its bf16 plan, the buffers, batches and dropout rates
    of ``seed`` and ``case``, and the mask hash seed."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    model = build(cs, attrib, seed, case)
    plan16 = cs.train_plan(model, bf16=True)
    cs.check(plan16.n_drop == 5, 'expected 5 dropout slots')
    bufs, xs, ys = cs.train_inputs(model, plan16, rng, steps)
    drops = ft.drop_rates(model.net).to(cs.DEVICE)
    if case == 'separate_p0':
        drops = torch.zeros_like(drops)
    return model, plan16, bufs, xs, ys, drops, int(rng.integers(1 << 31))


def inspect(cs, attrib, ft, seed, case, steps, step, repeats):
    """One step of ``seed`` and ``case`` (from the plain bf16 state, as the
    step check starts it) taken apart: whether ``repeats`` launches of the
    kernel agree bit for bit, whether recording the ReLU decisions changes
    it, the ReLU decisions each version took, each version's loss, and per
    Linear block (W, bias, BN scale and shift) of m and of theta's change
    the rms and max of the kernel's, the witnesses' and the gap's
    distances to the card's plain step."""
    import torch
    _, plan, bufs, xs, ys, drops, hash_seed = problem(cs, attrib, ft, seed,
                                                     case, steps)
    plan32 = dataclasses.replace(plan, bf16=False)
    state = [b.clone() for b in bufs]
    lr = LR

    def args(i):
        return (xs[i:i + 1], ys[i:i + 1], lr, cs.TRAIN_STEP0 + i,
                (hash_seed + i * ft.SALT_STEP) & 0xFFFFFFFF, drops)
    for i in range(step):
        state = list(ft.fused_epoch_reference(
            plan, *[b.clone() for b in state], *args(i))[:4])
    shape = (1, plan.num_members, plan.n_bn, plan.batch, ft.LANES)
    signs = [torch.zeros(shape, dtype=torch.uint8, device=xs.device)
             for _ in range(2)]
    runs = [ft.fused_epoch(plan, *[b.clone() for b in state], *args(step))
            for _ in range(repeats)]
    signed = ft.fused_epoch(plan, *[b.clone() for b in state], *args(step),
                            signs=signs[0])
    want = ft.fused_epoch_reference(plan, *[b.clone() for b in state],
                                    *args(step), signs=signs[1])
    versions = {
        'kernel': runs[0],
        'fp32': ft.fused_epoch_reference(plan32, *[b.clone() for b in state],
                                         *args(step)),
        'tensor_cores': ft.fused_epoch_reference(
            plan, *[b.clone() for b in state], *args(step),
            products=attrib.tensor_core_products),
        'host': [t.to(xs.device) for t in ft.fused_epoch_reference(
            plan, *[b.to('cpu', copy=True) for b in state],
            *[a.cpu() if torch.is_tensor(a) else a for a in args(step)])]}
    out = {'seed': seed, 'case': case, 'step': step, 'repeats': repeats,
           'repeats_bit_equal': all(
               all(torch.equal(a, b) for a, b in zip(r, runs[0]))
               for r in runs[1:]),
           'recording_changes_nothing': all(
               torch.equal(a, b) for a, b in zip(signed, runs[0])),
           'relu_decisions_apart': int((signs[0] != signs[1]).sum()),
           'losses': {k: float(v[4][0]) for k, v in versions.items()},
           'plain_loss': float(want[4][0]), 'blocks': []}
    # the unclipped gradients (the plan without its clip, recovered from
    # m): the global norm each version clips by, where the kernel's
    # gradient parts from the plain step's most, and each BatchNorm's
    # smallest batch variance in the plain forward
    b1 = float(plan.b1)
    noclip = dataclasses.replace(plan, clip=None)

    def raw(run, p=noclip, **kw):
        got = run(p, *[b.clone() for b in state], *args(step), **kw)[1]
        return ((got - b1 * state[1]) / (1 - b1)).double()
    g_plain, g_kernel = raw(ft.fused_epoch_reference), raw(ft.fused_epoch)
    g_fp32 = raw(ft.fused_epoch_reference, dataclasses.replace(noclip,
                                                               bf16=False))
    apart = (g_kernel - g_plain).abs()
    where = []
    for flat in apart.flatten().topk(8).indices.tolist():
        row, lane = divmod(flat, ft.LANES)
        block = next(((j, part) for j, lin in enumerate(plan.lins)
                      for part, (off, n) in (
                          ('w', (lin.w_off, lin.in_rows)), ('b', (lin.b_off, 1)),
                          ('bn_scale', (lin.g_off, 1)),
                          ('bn_shift', (lin.be_off, 1)))
                      if off >= 0 and off <= row % plan.slab_rows < off + n),
                     None)
        where.append({'block': block, 'row': row % plan.slab_rows,
                      'lane': lane, 'kernel': float(g_kernel.flatten()[flat]),
                      'plain': float(g_plain.flatten()[flat]),
                      'fp32': float(g_fp32.flatten()[flat])})
    saved, k = ft._saved(plan), ft._constants(plan)
    pred = ft._forward(plan, k, state[0].clone(), state[3].clone(), xs[step],
                       0, 0, args(step)[4],
                       ft._drop_tensor(plan, drops, xs.device), saved)
    margin = (pred[:, 0] - ys[step][:, 0]).abs().sort().values
    bias = plan.lins[-1].b_off
    out['l1'] = {
        'smallest_margins': margin[:4].tolist(),
        'output_bias_grad_x_div': {
            name: float(t[bias, 0] * float(k['loss_div']))
            for name, t in (('kernel', g_kernel), ('plain', g_plain))},
        'loss_flips_clipped': int(attrib.loss_flips(
            plan, state[1], runs[0][1], want[1]).sum()),
        'loss_flips_unclipped': int(attrib.loss_flips(
            noclip, state[1], ft.fused_epoch(
                noclip, *[b.clone() for b in state], *args(step))[1],
            ft.fused_epoch_reference(noclip, *[b.clone() for b in state],
                                     *args(step))[1]).sum())}
    eps = float(plan.bn_eps)
    out['unclipped'] = {
        'clip': plan.clip,
        'norm': {k: float(t.norm()) for k, t in (
            ('kernel', g_kernel), ('plain', g_plain), ('fp32', g_fp32))},
        'kernel_apart_rms': float(apart.square().mean().sqrt()),
        'gap_rms': float((g_fp32 - g_plain).square().mean().sqrt()),
        'largest_apart': where,
        'bn_min_var': [float((1 / inv.double() ** 2 - eps).min())
                       for inv in saved['inv']]}
    rows = plan.slab_rows
    for j, lin in enumerate(plan.lins):
        spans = {'w': (lin.w_off, lin.in_w), 'b': (lin.b_off, 1),
                 'bn_scale': (lin.g_off, 1), 'bn_shift': (lin.be_off, 1)}
        for part, (off, n) in spans.items():
            if off < 0:
                continue
            block = {'linear': j, 'part': part}
            for buf, idx in (('theta', 0), ('m', 1)):
                def cut(t):
                    t = t[idx] - (state[0] if idx == 0 else 0)
                    return t[:rows][off:off + n, :lin.out_w].double()
                w = cut(want)
                for name, t in (('gap', versions['fp32']),
                                *versions.items()):
                    if name == 'fp32':
                        continue
                    d = cut(t) - w
                    block[f'{buf}_{name}'] = [
                        float(d.square().mean().sqrt()),
                        float(d.abs().max())]
            out['blocks'].append(block)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--seeds', type=seeds, default=seeds('0-3'))
    parser.add_argument('--steps', type=int, default=64)
    parser.add_argument('--cases', default=','.join(CASES))
    parser.add_argument('--plant', choices=tuple(PLANTS))
    parser.add_argument('--inspect', default='',
                        help='SEED:CASE:STEP[,...]: take these steps apart '
                             '(see inspect) instead of the sweep')
    parser.add_argument('--repeats', type=int, default=20)
    parser.add_argument('--out', default=os.path.join(
        'build', 'bf16_mc_stepwise.jsonl'))
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('bf16_mc_stepwise: no CUDA card', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from nnueehcs_tpu_torch import attrib
    from nnueehcs_tpu_torch.ops import ablate_epoch as ae
    from nnueehcs_tpu_torch.ops import fused_train as ft

    torch.backends.cuda.matmul.allow_tf32 = False
    bars = {'rms_share': attrib.BF16_RMS_SHARE,
            'max_share': attrib.BF16_MAX_SHARE}
    if args.inspect:
        for item in args.inspect.split(','):
            seed, case, step = item.split(':')
            print(json.dumps(inspect(cs, attrib, ft, int(seed), case,
                                     args.steps, int(step), args.repeats)),
                  flush=True)
        print(attrib.nvidia_smi('name,power.limit'))
        return 0
    cases = args.cases.split(',')
    for case in cases:
        if case not in CASES:
            parser.error(f'unknown case {case!r}; the cases are {CASES}')
    os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
    with open(args.out, 'w') as log:
        for seed in args.seeds:
            for case in cases:
                model, plan16, bufs, xs, ys, drops, hash_seed = problem(
                    cs, attrib, ft, seed, case, args.steps)
                kernel = (planted_fault(ft, *PLANTS[args.plant],
                                        first=cs.TRAIN_STEP0)
                          if args.plant else ft.fused_epoch)
                records = []

                def on_step(rec):
                    records.append(rec)
                    log.write(json.dumps(dict(seed=seed, case=case,
                                              plant=args.plant, **rec))
                              + '\n')
                out = attrib.stepwise_vs_plain_bf16(
                    plan16, bufs, xs, ys, LR, cs.TRAIN_STEP0, hash_seed,
                    drops, gate=False, epoch=kernel, on_step=on_step,
                    witnessed=case != 'randomized')
                print(json.dumps({
                    'seed': seed, 'case': case, 'plant': args.plant,
                    'form': 'cluster bf16 (kernel 3b)',
                    'steps': args.steps, 'failures': len(out['failures']),
                    'first_failed_step': out['first_failed_step'],
                    'first_failure': (out['failures'] or [None])[0],
                    'flips': out['flips'], 'loss_flips': out['loss_flips'],
                    'adam_v_err_max': out['adam_v_err_max'],
                    'excursions': out['excursions'],
                    'losses': {k: out['losses'][k] for k in (
                        'rms_err', 'max_abs_err', 'gap_rms', 'gap_max',
                        'witness_rms', 'bar_rms', 'bar_max')},
                    **summarize(records, bars)}), flush=True)
                if case != 'separate' or args.plant:
                    continue
                # the one-block form, through the probe: fp32, no dropout
                plan32 = ae.probe_plan(cs.train_plan(model))
                for form, epoch in (('one-block fp32 (probe prod)',
                                     attrib.probe_prod),
                                    ('cluster fp32 (kernel 3)',
                                     ft.fused_epoch)):
                    try:
                        res = attrib.stepwise_vs_plain(
                            plan32, [b.clone() for b in bufs], xs, ys, LR,
                            cs.TRAIN_STEP0, hash_seed, None, epoch=epoch)
                        verdict = None
                    except RuntimeError as err:
                        res, verdict = {}, str(err)[:2000]
                    print(json.dumps({
                        'seed': seed, 'case': 'separate_no_dropout',
                        'form': form, 'steps': args.steps,
                        'failure': verdict,
                        **{k: res.get(k) for k in (
                            'flips', 'loss_flips', 'over_tol',
                            'over_tol_outside_reach',
                            'max_abs_err_outside_reach')}}), flush=True)
    print(json.dumps({'seeds': len(args.seeds), 'cases': cases,
                      'plant': args.plant, 'records': args.out,
                      'kind': torch.cuda.get_device_name(0)}))
    print(attrib.nvidia_smi('name,power.limit'))
    return 0


if __name__ == '__main__':
    sys.exit(main())
