#!/usr/bin/env python3
"""Split one step of the training kernel (kernel 3, its bf16 form 3b) into
its phases on one card:

    python3 tools/train_step_phases.py [--seed N]

Builds the kernel library with ``-DNNUEEHCS_TRAIN_STAMPS`` beside the
package's own: thread 0 of member 0's first block then records
``%globaltimer`` at each phase boundary of the epoch's middle step
(``fused_train_cluster.cuh`` ``TRAIN_STAMP``). Runs a 20-step epoch of the
flagship ensemble (8 members, 7 x 128, batch 128, joint-mean l1) and of a
single net (MC dropout, batch 128), fp32 and bf16, and prints per plan one
JSON line of microseconds: the sweep launch (joint mean only) and the step
launch, the forward layers (product, BatchNorm statistics and EMA, x-hat
and the local write, the DSMEM broadcast, the cluster barrier), the
backward layers (parameters with ReLU and BatchNorm backward, the d
exchange with the block input a, the barrier, dW with the bias gradient,
d W^T, the closing barrier), the loss and the reduction, each summed over
the layers too; then the card's ``nvidia-smi`` name and power limit. The
stamps are one thread's clock at the boundaries: what block 0 waits for at
a barrier is counted in the barrier. It needs a CUDA card.

Stamp ids: forward layer li at 100 + 10 li (sweep) or 300 + 10 li (step)
plus 0 (weights arrived), 1 (product), 4 (statistics), 5 (local write),
2 (broadcast), 3 (barrier); backward layer li at 500 + 10 li plus 0
(weights arrived), 1 (ReLU and BatchNorm backward), 2 (d exchanged, a
formed), 3 (barrier), 4 (dW and bias), 5 (d W^T), 6 (barrier); the step
launch at 900 (start), 901 (forward done, or the joint predictions
staged), 902 (joint mean formed), 903 (loss), 904 (barrier), 905
(backward), 906 (reduction); the sweep launch at 950, 951, 952.
"""
import argparse
import ctypes
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
FWD = {'product': 1, 'statistics': 4, 'local_write': 5, 'broadcast': 2,
       'barrier': 3}
BWD = {'relu_batchnorm': 1, 'd_exchange_and_a': 2, 'barrier': 3,
       'dW_and_bias': 4, 'dWT': 5, 'closing_barrier': 6}


def stamps_library():
    lib, _ = _build.load(('-DNNUEEHCS_TRAIN_STAMPS',))
    for name in ('nnueehcs_train_stamps', 'nnueehcs_train_stamps_bf16'):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
    return lib


def phases(t, n, joint):
    """Microseconds between the stamps ``t`` (id -> ns) of a plan with
    ``n`` blocks."""
    us = lambda a, b: (t[b] - t[a]) / 1e3  # noqa: E731
    out = {}
    base = 100 if joint else 300
    fwd = [{name: us(base + 10 * li + prev, base + 10 * li + j)
            for (name, j), prev in zip(FWD.items(), (0, 1, 4, 5, 2))}
           for li in range(n - 1)]
    fwd.append({'product': us(base + 10 * (n - 1), base + 10 * (n - 1) + 1)})
    bwd = []
    for li in range(n - 1, -1, -1):
        b = 500 + 10 * li
        row = {name: us(b + j - 1, b + j) for name, j in BWD.items()
               if b + j in t and b + j - 1 in t}
        bwd.append(row)
    out['forward_layers'] = fwd
    out['backward_layers'] = bwd
    out['forward_sums'] = {k: sum(r.get(k, 0.0) for r in fwd) for k in FWD}
    out['backward_sums'] = {k: sum(r.get(k, 0.0) for r in bwd) for k in BWD}
    if joint:
        out['sweep_launch'] = us(950, 952)
        out['between_launches'] = us(952, 900)
        out['joint_predictions_staged'] = us(900, 901)
        out['joint_mean'] = us(901, 902)
        out['loss'] = us(902, 903)
    else:
        out['forward'] = us(900, 901)
        out['loss'] = us(901, 903)
    out['barrier_before_backward'] = us(903, 904)
    out['backward'] = us(904, 905)
    out['reduction'] = us(905, 906)
    out['step_launch'] = us(900, 906)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('train_step_phases: no CUDA card', file=sys.stderr)
        return 2
    lib = stamps_library()
    rng = np.random.default_rng(args.seed)
    kind = torch.cuda.get_device_name(0)
    buf = (ctypes.c_ulonglong * 1024)()
    models = {'flagship_ensemble': EnsembleModelBuilder(
        FLAGSHIP, {'num_models': MEMBERS}, seed=args.seed,
        device='cuda').build(), 'single_net_mc_dropout': build_mc(args.seed)}
    for read in (lib.nnueehcs_train_stamps, lib.nnueehcs_train_stamps_bf16):
        read(ctypes.addressof(buf))      # clears them
    for name, model in models.items():
        drops = ft.drop_rates(model.net).to('cuda')
        for bf16 in (False, True):
            plan = train_plan(model, bf16=bf16)
            bufs, xs, ys = train_inputs(model, plan, rng, STEPS)
            for _ in range(2):          # the last epoch's stamps are read
                ft.launch_epoch(lib, plan, *[b.clone() for b in bufs], xs,
                                ys, 5e-5, 5, 1, drops)
            torch.cuda.synchronize()
            read = lib.nnueehcs_train_stamps_bf16 if bf16 \
                else lib.nnueehcs_train_stamps
            err = read(ctypes.addressof(buf))
            if err:
                raise RuntimeError(f'reading the stamps: CUDA error {err}')
            t = {i: buf[i] for i in range(1024) if buf[i]}
            out = phases(t, len(plan.lins), not plan.single_sweep)
            print(json.dumps({'plan': name, 'bf16': bf16,
                              'members': plan.num_members,
                              'batch': plan.batch, 'cluster': ft.CLUSTER,
                              'us': out, 'device': kind}), flush=True)
    print(nvidia_smi('name,power.limit'), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
