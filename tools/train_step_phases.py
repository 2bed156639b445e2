#!/usr/bin/env python3
"""Split one step of the training kernel (kernel 3, its bf16 form 3b) into
its phases on one card:

    python3 tools/train_step_phases.py [--seed N]

Builds the kernel library with the phase stamps (``csrc/stamps.cuh``,
``_build.stamped_library``) beside the package's own: thread 0 of member
0's first block then sums the SM clock it spends in each phase of the
epoch's middle step (``fused_train_cluster.cuh``: ``STAMP_BEGIN`` at the
start of each launch of that step, ``STAMP`` at each phase boundary).
Runs a 20-step epoch of the flagship ensemble (8 members, 7 x 128, batch
128, joint-mean l1) and of a single net (MC dropout, batch 128), fp32 and
bf16, once to warm up and once stamped, and prints per plan one JSON line
of microseconds (clock sums scaled by the stamped launches' wall time):
the sweep launch (joint mean only) and the step launch, the forward layers
(product, BatchNorm statistics and EMA, x-hat and the local write, the
DSMEM broadcast, the cluster barrier, the wait for the next layer's
weights), the backward layers (parameters with ReLU and BatchNorm
backward, the d exchange with the block input a, the barrier, dW with the
bias gradient, d W^T, the closing barrier), the loss and the reduction,
each summed over the layers too; then the card's ``nvidia-smi`` name and
power limit. What block 0 waits for at a barrier is counted in the
barrier. It needs a CUDA card.

Phase ids (each phase runs from its stamp to the next): forward layer li
at 100 + 10 li (sweep) or 300 + 10 li (step) plus 0 (the product), 1
(statistics), 4 (local write), 5 (broadcast), 2 (barrier), 3 (the wait for
the next layer's weights), the last layer 0 (the product) and 1 (to the
next phase of the launch); backward layer li at 500 + 10 li plus 0
(ReLU and BatchNorm backward), 1 (d exchanged, a formed), 2 (barrier), 3
(dW and bias), 4 (d W^T), 5 (closing barrier), 6 (the wait for the next
layer's weights); layer 0 ends after dW and bias. The step launch: 900
(the forward, or the joint predictions staged), 901 (the loss, or the
joint mean formed), 902 (the joint mean's loss), 903 (barrier), 904
(backward), 905 (reduction); the sweep launch: 950 (weights and x), 951
(the forward and the prediction's write).
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (FLAGSHIP, MEMBERS, build_mc,  # noqa: E402
                        train_inputs, train_plan)
from nnueehcs_tpu_torch.attrib import nvidia_smi  # noqa: E402
from nnueehcs_tpu_torch.model_builder import EnsembleModelBuilder  # noqa: E402
from nnueehcs_tpu_torch.ops import _build  # noqa: E402
from nnueehcs_tpu_torch.ops import fused_train as ft  # noqa: E402

STEPS = 20
# forward phase: its offset from 100 + 10 li (300 + 10 li)
FWD = {'product': 0, 'statistics': 1, 'local_write': 4, 'broadcast': 5,
       'barrier': 2, 'next_weights': 3}
# backward phase: its offset from 500 + 10 li (layer 0 stops after dW)
BWD = {'relu_batchnorm': 0, 'd_exchange_and_a': 1, 'barrier': 2,
       'dW_and_bias': 3, 'dWT': 4, 'closing_barrier': 5, 'next_weights': 6}


def phases(us, n, joint):
    """Microseconds by phase from ``us`` (slot -> us, the phase that each
    stamp id opens) of a plan with ``n`` Linears."""
    out = {}
    base = 100 if joint else 300
    fwd = [{name: us[base + 10 * li + j] for name, j in FWD.items()}
           for li in range(n - 1)]
    last = base + 10 * (n - 1)
    fwd.append({'product': us[last], 'after_product': us[last + 1]})
    bwd = [{name: us[500 + 10 * li + j] for name, j in BWD.items()
            if li > 0 or j <= BWD['dW_and_bias']}
           for li in range(n - 1, -1, -1)]
    out['forward_layers'] = fwd
    out['backward_layers'] = bwd
    out['forward_sums'] = {k: sum(r.get(k, 0.0) for r in fwd) for k in FWD}
    out['backward_sums'] = {k: sum(r.get(k, 0.0) for r in bwd) for k in BWD}
    layers = lambda lo: sum(us[lo:lo + 100])  # noqa: E731
    if joint:
        out['sweep_launch'] = us[950] + us[951] + layers(100)
        out['joint_predictions_staged'] = us[900]
        out['joint_mean'] = us[901]
        out['loss'] = us[902]
    else:
        out['forward'] = us[900] + layers(300)
        out['loss'] = us[901]
    out['barrier_before_backward'] = us[903]
    out['backward'] = us[904] + layers(500)
    out['reduction'] = us[905]
    out['step_launch'] = (sum(us[900:906]) + layers(500)
                          + (0.0 if joint else layers(300)))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('train_step_phases: no CUDA card', file=sys.stderr)
        return 2
    lib = _build.stamped_library()
    rng = np.random.default_rng(args.seed)
    kind = torch.cuda.get_device_name(0)
    models = {'flagship_ensemble': EnsembleModelBuilder(
        FLAGSHIP, {'num_models': MEMBERS}, seed=args.seed,
        device='cuda').build(), 'single_net_mc_dropout': build_mc(args.seed)}
    for name, model in models.items():
        drops = ft.drop_rates(model.net).to('cuda')
        for bf16 in (False, True):
            unit = 'fused_train_bf16' if bf16 else 'fused_train'
            plan = train_plan(model, bf16=bf16)
            bufs, xs, ys = train_inputs(model, plan, rng, STEPS)
            for _ in range(2):          # the second epoch's stamps are read
                _build.read_stamps(lib, unit)
                ft.launch_epoch(lib, plan, *[b.clone() for b in bufs], xs,
                                ys, 5e-5, 5, 1, drops)
                torch.cuda.synchronize()
            cycles, wall_ns = _build.read_stamps(lib, unit)
            per_ns = sum(cycles) / wall_ns
            us = [c / per_ns / 1e3 for c in cycles]
            out = phases(us, len(plan.lins), not plan.single_sweep)
            print(json.dumps({'plan': name, 'bf16': bf16,
                              'members': plan.num_members,
                              'batch': plan.batch, 'cluster': ft.CLUSTER,
                              'us': out, 'stamped_wall_us': wall_ns / 1e3,
                              'sm_clock_ghz': per_ns, 'device': kind}),
                  flush=True)
    print(nvidia_smi('name,power.limit'), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
