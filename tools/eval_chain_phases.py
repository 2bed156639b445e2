#!/usr/bin/env python3
"""Split the eval kernels on wgmma (the bf16 1b, 2b and 5b, the fp32 2 and
5 on 3xTF32) and the KDE kernel (4) into their phases on one card:

    python3 tools/eval_chain_phases.py [--seed N]

Builds the kernel library with the phase stamps (``csrc/stamps.cuh``,
``_build.stamped_library``) beside the package's own: thread 0 of one block
then sums the SM clock it spends in each phase, and the wall time of its
span. Runs each kernel through its wrapper on the stamped library once to
warm up and once stamped at the flagship shape (5 inputs, 7 Linear layers
128 wide, weights from ``--seed``; MC dropout: 262,144 rows x 128 samples,
p = 0.1; Δ-UQ: 65,536 rows x 229 anchors; the 8-member ensemble: 262,144
rows, stamped in block 0, its cluster's leader, and in block 1, a peer
that sends its member to the leader; the fp32 kernels 2 and 5 at the same
shapes, stamped in block 0, the leader that merges its cluster's groups,
and in block 1, a peer that sends its group; KDE: 262,144 queries x 16,384
references) and prints one JSON line per kernel: microseconds per phase of
the stamped thread (clock sums scaled by the span's wall time), each
phase's share, the span's wall time, and the wrapper's time by CUDA events
on the package's library; then a line of the package library's build
(``sass.eval_chain_sass``: each form's registers, spills and HGMMA
instructions, and the MC kernel's mask loop, its instructions per hash and
their opcodes); then the card's ``nvidia-smi`` name and power limit. What
the thread waits for at a barrier is counted in the barrier. It needs a
CUDA card.
"""
import argparse
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (ANCHORED_ROWS, IN_DIM, KDE_FIT_ROWS,  # noqa: E402
                        MC_SAMPLES, ROWS, build_anchored, build_mc,
                        build_model, in_bf16, ptxas_report)
from nnueehcs_tpu_torch.attrib import event_ms, nvidia_smi  # noqa: E402
from nnueehcs_tpu_torch.model_builder import DeltaUQMLPModelBuilder  # noqa: E402
from nnueehcs_tpu_torch.ops import _build  # noqa: E402
from nnueehcs_tpu_torch.ops import fused_anchored as fa  # noqa: E402
from nnueehcs_tpu_torch.ops import fused_mc_dropout as mc  # noqa: E402
from nnueehcs_tpu_torch.ops.fused_ensemble import (  # noqa: E402
    fused_forward_prefolded, prepare_fused_weights)
from nnueehcs_tpu_torch.ops.kde import bandwidth_value, kde_logpdf  # noqa: E402
from nnueehcs_tpu_torch.sass import eval_chain_sass  # noqa: E402

# the phase ids the kernels stamp (fused_chain_wgmma.cuh, fused_mc_dropout.cu,
# fused_anchored.cu, fused_ensemble.cu), and kde.cu's
NAMES = {0: 'other', 1: 'weights_wait', 2: 'x_fragments',
         3: 'products_issue', 4: 'mask_hash_in_flight', 5: 'products_wait',
         6: 'epilogue', 7: 'u_plus_v', 8: 'last_layer_and_statistics',
         9: 'write_statistics', 10: 'slot_release', 11: 'dsmem_send',
         12: 'dsmem_wait', 13: 'member_statistics'}
KDE_NAMES = {0: 'query_operands', 1: 'reference_staging',
             2: 'tensor_core_products', 3: 'log_sum_exp',
             4: 'merge_and_write'}


@contextlib.contextmanager
def wrappers_on(lib):
    """The wrappers launch from ``lib`` (they take ``_build.library()``)."""
    package = _build.library
    _build.library = lambda: lib
    try:
        yield
    finally:
        _build.library = package


def split(cycles, wall_ns, names=NAMES):
    """{phase: us} and the clock rate (cycles a ns) from the stamps."""
    per_ns = sum(cycles) / wall_ns if wall_ns else float('nan')
    us = {names.get(i, f'phase_{i}'): c / per_ns / 1e3
          for i, c in enumerate(cycles) if c}
    return us, per_ns


def run(lib, unit, launch, block=0, names=NAMES):
    _build.stamp_block(lib, unit, block)
    with wrappers_on(lib):
        launch()
        torch.cuda.synchronize()
        _build.read_stamps(lib, unit)     # clears the warm-up's
        launch()
        torch.cuda.synchronize()
    _build.stamp_block(lib, unit, 0)
    cycles, wall_ns = _build.read_stamps(lib, unit)
    us, per_ns = split(cycles, wall_ns, names)
    total = sum(us.values())
    return {'us': us, 'share': {k: v / total for k, v in us.items()},
            'block': block, 'block_wall_us': wall_ns / 1e3,
            'sm_clock_ghz': per_ns}


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
    mw32 = mc.prepare_mc_weights(build_mc(args.seed).net)
    mw = in_bf16(build_mc(args.seed), mc.prepare_mc_weights)
    dq = build_anchored(DeltaUQMLPModelBuilder, args.seed)
    aw32 = fa.prepare_fused_anchored(dq.net)
    aw = in_bf16(dq, fa.prepare_fused_anchored)
    xa = x[:ANCHORED_ROWS].contiguous()
    anchors = torch.as_tensor(dq.anchors, dtype=torch.float32, device='cuda')

    fw16 = in_bf16(build_model(args.seed), prepare_fused_weights)
    corpus = torch.as_tensor(rng.normal(size=(KDE_FIT_ROWS, IN_DIM)),
                             dtype=torch.float32, device='cuda')
    h = bandwidth_value('silverman', KDE_FIT_ROWS, IN_DIM)

    def mc_launch():
        mc.fused_mc_forward(mw, x, MC_SAMPLES, 7)

    def dq_launch():
        fa.fused_anchored_stats(aw, xa, anchors)

    def mc32_launch():
        mc.fused_mc_forward(mw32, x, MC_SAMPLES, 7)

    def dq32_launch():
        fa.fused_anchored_stats(aw32, xa, anchors)

    def ens_launch():
        fused_forward_prefolded(fw16, x)

    def kde_launch():
        kde_logpdf(x, corpus, h)

    ens_shape = {'rows': ROWS, 'members': fw16.num_members}
    mc_shape = {'rows': ROWS, 'samples': MC_SAMPLES}
    dq_shape = {'rows': ANCHORED_ROWS, 'anchors': anchors.shape[0]}
    for name, unit, launch, shape, block, names in (
            ('fused_mc_dropout leader', 'fused_mc_dropout', mc32_launch,
             mc_shape, 0, NAMES),
            ('fused_mc_dropout peer', 'fused_mc_dropout', mc32_launch,
             mc_shape, 1, NAMES),
            ('fused_anchored leader', 'fused_anchored', dq32_launch,
             dq_shape, 0, NAMES),
            ('fused_anchored peer', 'fused_anchored', dq32_launch,
             dq_shape, 1, NAMES),
            ('fused_mc_dropout_bf16', 'fused_mc_dropout', mc_launch,
             {'rows': ROWS, 'samples': MC_SAMPLES}, 0, NAMES),
            ('fused_anchored_bf16', 'fused_anchored', dq_launch,
             {'rows': ANCHORED_ROWS, 'anchors': anchors.shape[0]}, 0, NAMES),
            ('fused_ensemble_bf16 leader', 'fused_ensemble', ens_launch,
             ens_shape, 0, NAMES),
            ('fused_ensemble_bf16 peer', 'fused_ensemble', ens_launch,
             ens_shape, 1, NAMES),
            ('kde', 'kde', kde_launch,
             {'rows': ROWS, 'references': KDE_FIT_ROWS}, 0, KDE_NAMES)):
        out = run(lib, unit, launch, block, names)
        kernel_t = event_ms(launch, warmup=2, trials=5)
        print(json.dumps({'kernel': name, **shape, **out,
                          'wrapper_ms_unstamped': kernel_t['median_ms'],
                          'device': kind}), flush=True)
    info = _build.build_info()
    print(json.dumps({'sass': eval_chain_sass(info.path,
                                              ptxas_report(info.log),
                                              info.log)}),
          flush=True)
    print(nvidia_smi('name,power.limit'), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
