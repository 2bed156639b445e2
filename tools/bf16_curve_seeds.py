#!/usr/bin/env python3
"""Kernel 3b's bf16 loss-curve check of ``chip_smoke.py`` over seeds, on
one card:

    python3 tools/bf16_curve_seeds.py [--seeds 0-7] [--stepwise]
                                      [--plant member_lr]

For each seed: the flagship ensemble as the main path builds it (8
members, 5 inputs, 7 Linear layers 128 wide, BatchNorm scale 1 and shift
0, weights from the seed), 64 batches of 128 rows of the smooth target,
non-zero Adam moments and the dropout seed drawn from
``numpy.random.default_rng(seed)``, one epoch at the flagship trial's
learning rate (5e-5) through kernel 3b, its plain bf16 version on the
card and on the host, and the plain fp32 version, from the same state.
``chip_smoke.py`` draws its curve's inputs after the earlier phases' draws
from one generator; here each seed's draws start the generator.

The curve mode prints one JSON line per seed with two bars: ``gap_bar``,
the largest distance between the kernel's and the plain bf16 curve within
the largest distance between the plain bf16 and fp32 curves, and
``witness_bar``, that distance within BF16_WITNESS_SHARE of the largest
distance between the host's plain bf16 curve and the card's (two correct
bf16 versions, ``chip_smoke.py``'s bar). Then the pass counts.

``--stepwise`` runs ``attrib.stepwise_vs_plain_bf16`` over the 64 steps
instead, each step from the plain bf16 state: one JSON line per step
(ReLU and loss flips, v's error, each buffer's error shares, the bars it
passed), then the seed's summary with the first step that passed a bar.

``--plant member_lr`` replaces the kernel by a faulty one: kernel 3b step
by step, with member 0's parameters taken from a second launch at twice
the learning rate (Adam's moments and the running statistics do not
depend on it, so this is kernel 3b with member 0's learning rate
doubled). A check that passes it is too weak.

Ends with the card's name and power limit. It needs a CUDA card.
"""
import argparse
import json
import os
import sys


def seeds(text):
    lo, _, hi = text.partition('-')
    return list(range(int(lo), int(hi or lo) + 1))


def member_lr_fault(ft, plan):
    """Kernel 3b with member 0's learning rate doubled: each step launched
    at ``lr`` and at ``2 lr`` from the same state, member 0's parameters
    from the second."""
    import torch
    rows = plan.slab_rows

    def epoch(plan, theta, m, v, sigma, xs, ys, lr, step0, seed=0,
              drops=None, signs=None):
        losses = []
        for i in range(xs.shape[0]):
            args = (xs[i:i + 1], ys[i:i + 1])
            rest = (step0 + i, (seed + i * ft.SALT_STEP) & 0xFFFFFFFF, drops)
            sign = None if signs is None else signs[i:i + 1]
            fast = ft.fused_epoch(plan, theta.clone(), m.clone(), v.clone(),
                                  sigma.clone(), *args, 2 * lr, *rest)
            out = ft.fused_epoch(plan, theta, m, v, sigma, *args, lr, *rest,
                                 signs=sign)
            theta[:rows] = fast[0][:rows]
            losses.append(out[4])
        return theta, m, v, sigma, torch.cat(losses)
    return epoch


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--seeds', type=seeds, default=seeds('0-7'))
    parser.add_argument('--stepwise', action='store_true')
    parser.add_argument('--plant', choices=('member_lr',))
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('bf16_curve_seeds: no CUDA card', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from nnueehcs_tpu_torch import attrib
    from nnueehcs_tpu_torch.model_builder import EnsembleModelBuilder
    from nnueehcs_tpu_torch.ops import fused_train as ft

    torch.backends.cuda.matmul.allow_tf32 = False
    counts = {'gap_bar': 0, 'witness_bar': 0, 'stepwise': 0}
    for seed in args.seeds:
        rng = np.random.default_rng(seed)
        as_built = EnsembleModelBuilder(cs.FLAGSHIP,
                                        {'num_models': cs.MEMBERS},
                                        seed=seed, device=cs.DEVICE).build()
        plan16 = cs.train_plan(as_built, bf16=True)
        bufs, xs, ys = cs.train_inputs(as_built, plan16, rng,
                                       cs.BF16_CURVE_STEPS)
        hash_seed = int(rng.integers(1 << 31))
        lr = cs.TRAIN_MODEL_CONFIG['learning_rate']
        kernel = (member_lr_fault(ft, plan16) if args.plant
                  else ft.fused_epoch)
        if args.stepwise:
            out = attrib.stepwise_vs_plain_bf16(
                plan16, bufs, xs, ys, lr, cs.TRAIN_STEP0, hash_seed, None,
                gate=False, epoch=kernel,
                on_step=lambda rec: print(json.dumps(dict(seed=seed, **rec)),
                                          flush=True))
            ok = not out['failures']
            counts['stepwise'] += ok
            print(json.dumps({'seed': seed, 'plant': args.plant,
                              'stepwise_pass': ok, **out}), flush=True)
            continue
        curves = [run(plan, *[b.clone() for b in bufs], xs, ys, lr,
                      cs.TRAIN_STEP0, hash_seed)[4]
                  for run, plan in ((kernel, plan16),
                                    (ft.fused_epoch_reference, plan16),
                                    (ft.fused_epoch_reference,
                                     cs.train_plan(as_built)))]
        host = ft.fused_epoch_reference(
            plan16, *[b.to('cpu', copy=True) for b in bufs], xs.cpu(),
            ys.cpu(), lr, cs.TRAIN_STEP0, hash_seed)[4]
        res = cs.bf16_curve_bars(*curves, host)
        for bar in ('gap_bar', 'witness_bar'):
            counts[bar] += res[bar]
        print(json.dumps({'seed': seed, 'plant': args.plant, **res}),
              flush=True)
    print(json.dumps({'seeds': len(args.seeds), 'plant': args.plant,
                      'passed': counts,
                      'kind': torch.cuda.get_device_name(0)}))
    print(attrib.nvidia_smi('name,power.limit'))
    return 0


if __name__ == '__main__':
    sys.exit(main())
