#!/usr/bin/env python3
"""Kernel 3b's bf16 loss-curve check of ``chip_smoke.py`` over seeds, on
one card:

    python3 tools/bf16_curve_seeds.py [--seeds 0-7]

For each seed: the flagship ensemble as the main path builds it (8
members, 5 inputs, 7 Linear layers 128 wide, BatchNorm scale 1 and shift
0, weights from the seed), 64 batches of 128 rows of the smooth target,
non-zero Adam moments and the dropout seed drawn from
``numpy.random.default_rng(seed)``, one epoch at the flagship trial's
learning rate (5e-5) through kernel 3b, its plain bf16 version and the
plain fp32 version, from the same state. The check is ``chip_smoke.py``'s:
the largest distance between the kernel's and the plain bf16 loss curve
must not pass the largest distance between the plain bf16 and fp32
curves. ``chip_smoke.py`` draws its curve's inputs after the earlier
phases' draws from one generator; here each seed's draws start the
generator. Prints one JSON line per seed, then the pass count, the card's
name and power limit. It needs a CUDA card.
"""
import argparse
import json
import os
import sys


def seeds(text):
    lo, _, hi = text.partition('-')
    return list(range(int(lo), int(hi or lo) + 1))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--seeds', type=seeds, default=seeds('0-7'))
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('bf16_curve_seeds: no CUDA card', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from nnueehcs_tpu_torch.attrib import bf16_close, nvidia_smi
    from nnueehcs_tpu_torch.model_builder import EnsembleModelBuilder
    from nnueehcs_tpu_torch.ops import fused_train as ft

    torch.backends.cuda.matmul.allow_tf32 = False
    passed = 0
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
        curves = [run(plan, *[b.clone() for b in bufs], xs, ys, lr,
                      cs.TRAIN_STEP0, hash_seed)[4]
                  for run, plan in ((ft.fused_epoch, plan16),
                                    (ft.fused_epoch_reference, plan16),
                                    (ft.fused_epoch_reference,
                                     cs.train_plan(as_built)))]
        shares = bf16_close(f'seed {seed} loss curve', *curves, gate=False)
        apart = float((curves[0] - curves[1]).abs().max())
        gap = float((curves[1] - curves[2]).abs().max())
        ok = apart <= gap
        passed += ok
        print(json.dumps({'seed': seed, 'pass': ok, 'max_abs_diff': apart,
                          'gap_max': gap, 'curve': shares}), flush=True)
    print(json.dumps({'passed': passed, 'seeds': len(args.seeds),
                      'kind': torch.cuda.get_device_name(0)}))
    print(nvidia_smi('name,power.limit'))
    return 0


if __name__ == '__main__':
    sys.exit(main())
