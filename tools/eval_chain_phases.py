#!/usr/bin/env python3
"""Split the bf16 MC-dropout and anchored eval kernels (kernels 2b and 5b)
into their phases on one card:

    python3 tools/eval_chain_phases.py [--seed N]

Builds the kernel library with the phase stamps (``csrc/stamps.cuh``,
``_build.stamped_library``) beside the package's own: thread 0 of block 0
then sums the SM clock it spends in each phase, and the wall time of its
span. Runs each kernel through its wrapper (``fused_mc_forward``,
``fused_anchored_stats``) on the stamped library once to warm up and once
stamped at the flagship shape (MC dropout: 262,144 rows x 128 samples,
p = 0.1; Δ-UQ: 65,536 rows x 229 anchors; 5 inputs, 7 Linear layers 128
wide, weights from ``--seed``) and prints one JSON line per kernel:
microseconds per phase of block 0's thread 0 (clock sums scaled by the
span's wall time), each phase's share, the span's wall time, and the
wrapper's time by CUDA events on the package's library; then a line of the
package library's build (``sass.eval_chain_sass``: each form's registers,
spills and HGMMA instructions, and the MC kernel's mask loop, its
instructions per hash and their opcodes); then the card's ``nvidia-smi``
name and power limit. What the thread waits for at a barrier is counted
in the barrier. It needs a CUDA card.
"""
import argparse
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (ANCHORED_ROWS, IN_DIM, MC_SAMPLES, ROWS,  # noqa: E402
                        build_anchored, build_mc, in_bf16, ptxas_report)
from nnueehcs_tpu_torch.attrib import event_ms, nvidia_smi  # noqa: E402
from nnueehcs_tpu_torch.model_builder import DeltaUQMLPModelBuilder  # noqa: E402
from nnueehcs_tpu_torch.ops import _build  # noqa: E402
from nnueehcs_tpu_torch.ops import fused_anchored as fa  # noqa: E402
from nnueehcs_tpu_torch.ops import fused_mc_dropout as mc  # noqa: E402
from nnueehcs_tpu_torch.sass import eval_chain_sass  # noqa: E402

# the phase ids the kernels stamp (fused_chain_wgmma.cuh, fused_mc_dropout.cu,
# fused_anchored.cu)
NAMES = {0: 'other', 1: 'weights_wait', 2: 'x_fragments',
         3: 'products_issue', 4: 'mask_hash_in_flight', 5: 'products_wait',
         6: 'epilogue', 7: 'u_plus_v', 8: 'last_layer_and_statistics',
         9: 'write_statistics', 10: 'slot_release'}


@contextlib.contextmanager
def wrappers_on(lib):
    """The wrappers launch from ``lib`` (they take ``_build.library()``)."""
    package = _build.library
    _build.library = lambda: lib
    try:
        yield
    finally:
        _build.library = package


def split(cycles, wall_ns):
    """{phase: us} and the clock rate (cycles a ns) from the stamps."""
    per_ns = sum(cycles) / wall_ns if wall_ns else float('nan')
    us = {NAMES.get(i, f'phase_{i}'): c / per_ns / 1e3
          for i, c in enumerate(cycles) if c}
    return us, per_ns


def run(lib, unit, launch):
    with wrappers_on(lib):
        launch()
        torch.cuda.synchronize()
        _build.read_stamps(lib, unit)     # clears the warm-up's
        launch()
        torch.cuda.synchronize()
    cycles, wall_ns = _build.read_stamps(lib, unit)
    us, per_ns = split(cycles, wall_ns)
    total = sum(us.values())
    return {'us': us, 'share': {k: v / total for k, v in us.items()},
            'block_wall_us': wall_ns / 1e3, 'sm_clock_ghz': per_ns}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('eval_chain_phases: no CUDA card', file=sys.stderr)
        return 2
    lib = _build.stamped_library()
    kind = torch.cuda.get_device_name(0)
    rng = np.random.default_rng(args.seed)
    x = torch.as_tensor(rng.normal(size=(ROWS, IN_DIM)), dtype=torch.float32,
                        device='cuda')
    mw = in_bf16(build_mc(args.seed), mc.prepare_mc_weights)
    dq = build_anchored(DeltaUQMLPModelBuilder, args.seed)
    aw = in_bf16(dq, fa.prepare_fused_anchored)
    xa = x[:ANCHORED_ROWS].contiguous()
    anchors = torch.as_tensor(dq.anchors, dtype=torch.float32, device='cuda')

    def mc_launch():
        mc.fused_mc_forward(mw, x, MC_SAMPLES, 7)

    def dq_launch():
        fa.fused_anchored_stats(aw, xa, anchors)

    for name, unit, launch, shape in (
            ('fused_mc_dropout_bf16', 'fused_mc_dropout', mc_launch,
             {'rows': ROWS, 'samples': MC_SAMPLES}),
            ('fused_anchored_bf16', 'fused_anchored', dq_launch,
             {'rows': ANCHORED_ROWS, 'anchors': anchors.shape[0]})):
        out = run(lib, unit, launch)
        kernel_t = event_ms(launch, warmup=2, trials=5)
        print(json.dumps({'kernel': name, **shape, **out,
                          'wrapper_ms_unstamped': kernel_t['median_ms'],
                          'device': kind}), flush=True)
    info = _build.build_info()
    print(json.dumps({'sass': eval_chain_sass(info.path,
                                              ptxas_report(info.log))}),
          flush=True)
    print(nvidia_smi('name,power.limit'), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
