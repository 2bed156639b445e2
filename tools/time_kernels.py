#!/usr/bin/env python3
"""Time kernels 1 and 1b (the ensemble, fp32 and bf16), 10b (its packed
probe), 4 (KDE), 2 and 2b (MC dropout, fp32 and bf16), 5 and 5b (anchored,
fp32 and bf16), 3 and 3b (a training epoch, fp32 and bf16-mixed) at the
flagship shapes on one card, from the package of a given tree:

    python3 tools/time_kernels.py [--tree DIR] [--seed N]

``--tree`` is the root of a checkout of this repository (default: this
one); its package and its ``chip_smoke.py`` are imported from there and its
kernels built into its own ``build/``, so two trees (a parent commit
unpacked with ``git archive`` and this one) can be timed in turns in one
call on one card. Shapes: the 8-member ensemble (5 inputs, 7 Linear layers
128 wide, weights from ``--seed``, bf16-mixed) on 262,144 rows, the packed
probe on the same rows padded to 128 features, the KDE log density of
262,144 queries under a 16,384 x 5 corpus, and MC dropout on the same
262,144 rows with 128 samples (the flagship chain, rate 0.1, fp32 and
bf16), Δ-UQ's anchored pass on 65,536 rows with 229 anchors (the flagship
chain, fp32 and bf16), kernels 2 and 5 also on 1, 128, 4,096 and 12,800
rows (the validation pass's rows; kernel 2 there with its seed table, one
seed a 128-row batch) beside their PyTorch yardsticks (kernel 2's GEMM-only
reference, ``chip_smoke.mc_gemm_only``; kernel 5's ``addmm`` chain over the
anchored rows, ``chip_smoke.anchored_library``), and the training kernel
on a flagship epoch of 1,000 steps of 128
rows (the 8-member ensemble, clip 5, lr 5e-5, Adam moments drawn from
``--seed``; kernel 3 also with its learning rate read from the card and
with ``stop`` set, where the tree's ``fused_epoch`` takes them), and
kernel 1 in fp32 on 1, 128, 4,096, 12,800 and 262,144 rows of the
8-member ensemble and on 262,144 rows of 3, 15 and 28 members, each beside
its ``baddbmm`` chain (``chip_smoke.library_chain``) and with its
launch replayed from a CUDA graph (``graph_ms``: the card's time without
the wrapper's host work), the 12,800-row
validation pass through the model's ``validation_losses``, and the
``Predictor``'s 262,144-row ensemble request end to end (wall-clock
median, ``chip_smoke.timed_passes``) with the kernel's share of it. Each
kernel: CUDA events over
10 passes after 5 warm-ups (``attrib.event_ms``). Prints one JSON line per
kernel (median, extremes, spread, the tree, the card's name), then the
card's ``nvidia-smi`` name and power limit. It needs a CUDA card.

``--probes`` times the attribution probes of kernels 1 and 3 instead, at
the attribution batteries' shapes (``nnueehcs_tpu_torch.attrib``: the
flagship on 262,144 rows, and 500 steps of batch 128): ``ablate_forward``
in each mode, member cut (1, 2, 4) and layer cut (1, 3, 5), beside kernel
1 on the same rows, and ``ablate_epoch`` in each mode and with
``gn_fused`` and ``unroll`` 4, beside kernel 3 on the probe's plan; an
epoch over 3 runs after 1 warm-up.

``--ensemble-forms`` (this tree only) also times kernel 1b with fewer
consumer warpgroups than its layout takes (``MAX_WARPGROUPS['ensemble']``
lowered), and the same chains without the exchange: one member on eight
times the rows, one block a unit of tiles.
"""
import argparse
import json
import os
import sys

VALIDATION_ROWS = 12_800        # the flagship trial's validation pass
SMALL_ROWS = (1, 128, 4096, VALIDATION_ROWS)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--tree', default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--ensemble-forms', action='store_true')
    parser.add_argument('--probes', action='store_true')
    args = parser.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print('time_kernels: no CUDA card', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from nnueehcs_tpu_torch.attrib import event_ms, nvidia_smi
    from nnueehcs_tpu_torch.ops import ablate_forward as af
    from nnueehcs_tpu_torch.ops.fused_ensemble import (
        fused_forward_prefolded, prepare_fused_weights)
    from nnueehcs_tpu_torch.ops.fused_mc_dropout import (
        fused_mc_forward, prepare_mc_weights)
    from nnueehcs_tpu_torch.ops.kde import bandwidth_value, kde_logpdf
    package = os.path.dirname(sys.modules['nnueehcs_tpu_torch'].__file__)
    if not package.startswith(tree):
        raise RuntimeError(f'imported {package}, not the tree {tree}')

    kind = torch.cuda.get_device_name(0)
    if args.probes:
        probes(args.seed, tree, kind)
        print(nvidia_smi('name,power.limit'), flush=True)
        return 0
    rng = np.random.default_rng(args.seed)
    x = torch.as_tensor(rng.normal(size=(cs.ROWS, cs.IN_DIM)),
                        dtype=torch.float32, device='cuda')
    x_pad = F.pad(x, (0, cs.WIDTH - cs.IN_DIM))
    fw16 = cs.in_bf16(cs.build_model(args.seed), prepare_fused_weights)
    corpus = torch.as_tensor(rng.normal(size=(cs.KDE_FIT_ROWS, cs.IN_DIM)),
                             dtype=torch.float32, device='cuda')
    h = bandwidth_value('silverman', cs.KDE_FIT_ROWS, cs.IN_DIM)
    mw = prepare_mc_weights(cs.build_mc(args.seed).net)
    mw16 = cs.in_bf16(cs.build_mc(args.seed), prepare_mc_weights)
    from nnueehcs_tpu_torch.model_builder import DeltaUQMLPModelBuilder
    from nnueehcs_tpu_torch.ops.fused_anchored import (
        fused_anchored_stats, prepare_fused_anchored)
    dq = cs.build_anchored(DeltaUQMLPModelBuilder, args.seed)
    aw = prepare_fused_anchored(dq.net)
    aw16 = cs.in_bf16(cs.build_anchored(DeltaUQMLPModelBuilder, args.seed),
                      prepare_fused_anchored)
    anchors = dq.anchors
    xa = x[:cs.ANCHORED_ROWS].contiguous()
    from nnueehcs_tpu_torch.ops import fused_train as ft
    train = {}
    for bf16 in (False, True):
        model = cs.build_model(args.seed)
        plan = cs.train_plan(model, bf16=bf16)
        train[bf16] = (plan, *cs.train_inputs(
            model, plan, np.random.default_rng(args.seed), cs.EPOCH_STEPS))
    lr = cs.TRAIN_MODEL_CONFIG['learning_rate']

    def epoch(bf16, rate=lr, **kw):
        plan, bufs, xs, ys = train[bf16]
        return lambda: ft.fused_epoch(plan, *bufs, xs, ys, rate, 0, **kw)
    device_args = 'stop' in ft.fused_epoch.__code__.co_varnames
    steps = {'steps': cs.EPOCH_STEPS, 'batch': cs.TRAIN_BATCH,
             'members': cs.MEMBERS}
    cases = [('fused_train', epoch(False), steps),
             ('fused_train_bf16', epoch(True), steps)]
    if device_args:
        lr_dev = torch.full((1,), lr, dtype=torch.float32, device='cuda')
        cases += [
            ('fused_train', epoch(False, rate=lr_dev,
                                  stop=torch.zeros(1, dtype=torch.int32,
                                                   device='cuda')),
             dict(steps, form='lr and stop on the card, stop 0')),
            ('fused_train', epoch(False, rate=lr_dev,
                                  stop=torch.ones(1, dtype=torch.int32,
                                                  device='cuda')),
             dict(steps, form='stopped')),
            ('fused_train_bf16', epoch(True, rate=lr_dev,
                                       stop=torch.ones(1, dtype=torch.int32,
                                                       device='cuda')),
             dict(steps, form='stopped'))]
    for name, run, shape in cases + [
            ('fused_ensemble_bf16', lambda: fused_forward_prefolded(fw16, x),
             {'rows': cs.ROWS, 'members': fw16.num_members}),
            ('packed_forward_bf16', lambda: af.packed_forward(fw16, x_pad),
             {'rows': cs.ROWS, 'members': fw16.num_members}),
            ('kde', lambda: kde_logpdf(x, corpus, h),
             {'rows': cs.ROWS, 'references': cs.KDE_FIT_ROWS,
              'features': cs.IN_DIM}),
            ('fused_mc_dropout',
             lambda: fused_mc_forward(mw, x, cs.MC_SAMPLES, 7),
             {'rows': cs.ROWS, 'samples': cs.MC_SAMPLES}),
            ('fused_mc_dropout_bf16',
             lambda: fused_mc_forward(mw16, x, cs.MC_SAMPLES, 7),
             {'rows': cs.ROWS, 'samples': cs.MC_SAMPLES}),
            ('fused_anchored',
             lambda: fused_anchored_stats(aw, xa, anchors),
             {'rows': cs.ANCHORED_ROWS, 'anchors': cs.ANCHORS}),
            ('fused_anchored_bf16',
             lambda: fused_anchored_stats(aw16, xa, anchors),
             {'rows': cs.ANCHORED_ROWS, 'anchors': cs.ANCHORS})]:
        print(json.dumps({'kernel': name, 'tree': tree, **shape,
                          **event_ms(run), 'device': kind}), flush=True)
    # kernels 2 and 5 at small requests and the validation pass, each
    # beside its PyTorch yardstick on the same rows
    batch = cs.TRAIN_BATCH
    seeds = [(977 * b + 5) * 2654435761 % 2**32
             for b in range(-(-max(SMALL_ROWS) // batch))]
    for rows in SMALL_ROWS:
        xs = x[:rows].contiguous()
        table = {'seeds': seeds, 'rows_per_seed': batch} \
            if rows == VALIDATION_ROWS else {}
        for name, run, yardstick, shape in (
                ('fused_mc_dropout',
                 lambda: fused_mc_forward(mw, xs, cs.MC_SAMPLES, 7, **table),
                 lambda: cs.mc_gemm_only(mw, xs, cs.MC_SAMPLES),
                 {'samples': cs.MC_SAMPLES, 'seed_table': bool(table)}),
                ('fused_anchored',
                 lambda: fused_anchored_stats(aw, xs, anchors),
                 lambda: cs.anchored_library(aw, xs, anchors),
                 {'anchors': cs.ANCHORS})):
            print(json.dumps({'kernel': name, 'tree': tree, 'rows': rows,
                              **shape, **event_ms(run),
                              'library_ms': event_ms(yardstick)['median_ms'],
                              'device': kind}), flush=True)
    # kernel 1 (fp32) at a request's rows, the validation pass (one launch
    # through the model's validation_losses, 100 batches of 128) and the
    # flagship's rows, and at the BO trials' member counts, beside its
    # baddbmm chain; then the Predictor's ensemble request on the
    # flagship's rows and the kernel's share of it
    def graph_ms(fn):
        """fn's device time alone: its launch captured in a CUDA graph
        and the replays timed (no host work between them)."""
        fn()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return event_ms(graph.replay)['median_ms']

    model = cs.build_model(args.seed)
    fw = prepare_fused_weights(model.net)
    cases = [(fw, rows) for rows in (1, 128, 4096, VALIDATION_ROWS, cs.ROWS)]
    cases += [(prepare_fused_weights(cs.build_model(args.seed,
                                                    members=m).net), cs.ROWS)
              for m in (3, 15, 28)]
    for w, rows in cases:
        xs = x[:rows].contiguous()
        print(json.dumps({'kernel': 'fused_ensemble', 'tree': tree,
                          'rows': rows, 'members': w.num_members,
                          **event_ms(lambda: fused_forward_prefolded(w, xs)),
                          'graph_ms': graph_ms(
                              lambda: fused_forward_prefolded(w, xs)),
                          'library_ms': event_ms(
                              lambda: cs.library_chain(w, xs))['median_ms'],
                          'device': kind}), flush=True)
    batches = VALIDATION_ROWS // batch
    xv = x[:VALIDATION_ROWS].reshape(batches, batch, cs.IN_DIM)
    yv = torch.zeros((batches, batch, 1), device='cuda')
    print(json.dumps({'kernel': 'fused_ensemble', 'tree': tree,
                      'form': 'validation_losses', 'rows': VALIDATION_ROWS,
                      'members': fw.num_members,
                      **event_ms(lambda: model.validation_losses(xv, yv)),
                      'device': kind}), flush=True)
    from nnueehcs_tpu_torch.serving import Predictor
    predictor = Predictor(model, buckets=cs.DEFAULT_BUCKETS, device='cuda')
    x_host = x.cpu().numpy()
    e2e_ms = 1e3 * float(np.median(cs.timed_passes(
        lambda: predictor.predict(x_host), cs.WARMUP, cs.TRIALS)))
    kernel_ms = event_ms(lambda: fused_forward_prefolded(fw, x))['median_ms']
    print(json.dumps({'kernel': 'fused_ensemble', 'tree': tree,
                      'form': 'Predictor request', 'rows': cs.ROWS,
                      'members': fw.num_members, 'e2e_median_ms': e2e_ms,
                      'kernel_ms': kernel_ms,
                      'share_outside_kernel': 1 - kernel_ms / e2e_ms,
                      'device': kind}), flush=True)
    if args.ensemble_forms:
        from nnueehcs_tpu_torch.ops import fused_eval_chain as ec
        most = ec.MAX_WARPGROUPS['ensemble']
        for wgs in range(most - 1, 0, -1):
            ec.MAX_WARPGROUPS['ensemble'] = wgs
            ec._launch_layout.cache_clear()   # the layouts of the cap
            print(json.dumps({
                'kernel': 'fused_ensemble_bf16', 'warpgroups': wgs,
                'rows': cs.ROWS, 'members': fw16.num_members,
                **event_ms(lambda: fused_forward_prefolded(fw16, x)),
                'device': kind}), flush=True)
        ec.MAX_WARPGROUPS['ensemble'] = most
        ec._launch_layout.cache_clear()
        one = cs.in_bf16(cs.build_model(args.seed, members=1),
                         prepare_fused_weights)
        x8 = x.repeat(fw16.num_members, 1)
        print(json.dumps({
            'kernel': 'fused_ensemble_bf16', 'members': 1,
            'rows': x8.shape[0], 'note': 'the same chains, no exchange',
            **event_ms(lambda: fused_forward_prefolded(one, x8)),
            'device': kind}), flush=True)
    print(nvidia_smi('name,power.limit'), flush=True)
    return 0


def probes(seed, tree, kind):
    """The attribution probes at the batteries' shapes, each beside the
    kernel whose parts it times (see the module's ``--probes``)."""
    import torch
    from nnueehcs_tpu_torch import attrib
    from nnueehcs_tpu_torch.attrib import event_ms
    from nnueehcs_tpu_torch.ops import ablate_epoch as ae
    from nnueehcs_tpu_torch.ops import ablate_forward as af
    from nnueehcs_tpu_torch.ops import fused_train as ft
    from nnueehcs_tpu_torch.ops.fused_ensemble import fused_forward_prefolded
    torch.backends.cuda.matmul.allow_tf32 = False
    _, fw, x, x_pad, _, _ = attrib.forward_inputs(seed, 'cuda', attrib.ROWS)
    forward = [('fused_ensemble', {}, lambda: fused_forward_prefolded(fw, x))]
    for kw in ({}, {'mode': 'io_floor'}, {'mode': 'gemm_only'},
               {'mode': 'no_epi'}, {'n_out': 1},
               *({'num_members': m} for m in (1, 2, 4)),
               *({'num_layers': l} for l in (1, 3, 5))):
        forward.append(('ablate_forward', kw,
                        lambda kw=kw: af.ablate_forward(fw, x_pad, **kw)))
    for name, kw, run in forward:
        print(json.dumps({'kernel': name, 'tree': tree, 'rows': attrib.ROWS,
                          'members': fw.num_members, **kw, **event_ms(run),
                          'device': kind}), flush=True)
    _, plan, bufs, xs, ys = attrib.train_problem(seed, 'cuda',
                                                 steps=attrib.STEPS)
    train = [('fused_train', {}, lambda: ft.fused_epoch(
        ae.probe_plan(plan), *bufs, xs, ys, attrib.LR, 0))]
    for kw in ({}, *({'mode': m} for m in ae.MODES[1:]), {'gn_fused': True},
               {'unroll': 4}):
        train.append(('ablate_epoch', kw, lambda kw=kw: ae.ablate_epoch(
            plan, *bufs, xs, ys, attrib.LR, 0, **kw)))
    for name, kw, run in train:
        print(json.dumps({'kernel': name, 'tree': tree, 'steps': attrib.STEPS,
                          'batch': plan.batch, 'members': plan.num_members,
                          **kw, **event_ms(run, warmup=1, trials=3),
                          'device': kind}), flush=True)


if __name__ == '__main__':
    sys.exit(main())
