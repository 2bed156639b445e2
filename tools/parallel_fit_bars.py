#!/usr/bin/env python3
"""The sharded fits of ``chip_smoke.py``'s ``parallel`` phase over seeds,
with planted faults, in one gloo world of two ranks:

    python3 tools/parallel_fit_bars.py [--seeds 0-4] [--plant-seeds 0-1]
                                       [--plants all] [--device cuda:0]
                                       [--out FILE]

For each seed: the flagship ensemble (8 members, 5 inputs, 7 Linear
layers 128 wide with BatchNorm, weights from the seed), 5 epochs of 20
training steps of batch 128, each followed by 10 validation batches, of
``chip_smoke.parallel_fit_data`` on the per-step path
(``chip_smoke.parallel_fit``); rank 0 fits it unsharded, then both ranks
fit it on ``{'dp': 2}`` and on ``{'member': 2}``. Each sharded fit prints
one JSON line with its distances from the unsharded fit
(``chip_smoke.fit_readings``: the first 20 losses' largest, ``first``,
which the phase holds to TOL_CROSS; every step's, ``all``; the first
validation loss's relative distance, ``val_first_rel``, held to
PARALLEL_VAL_REL; the last one's, ``val_last_rel``) and the largest global
gradient norm of a step (``max_grad_norm``; the clip acts above
``gradient_clip_val`` = 5).

``--plants`` names faults of the sharded step, each installed in both
ranks for a ``{'dp': 2}`` fit on each of ``--plant-seeds`` (the package's
files are not changed; the methods are replaced in the ranks' memory):

- ``grad_mean``: gradients averaged over dp instead of summed;
- ``bn_grads_local``: BatchNorm's weights and biases keep each rank's own
  gradient (not summed over dp), so the ranks' copies drift apart;
- ``running_var_local``: the running variance unbiased with the rank's
  row count, not the global batch's;
- ``clip_norm_dp``: the clip norm's squares also summed over dp.

A bar that passes a planted fault does not see it. Ends with a summary
line (the largest clean reading of each bar over the seeds, and each
plant's smallest) and the card's ``nvidia-smi`` name and power limit.
``--device cpu`` runs both ranks on the CPU.
"""
import argparse
import contextlib
import json
import math
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANTS = ('grad_mean', 'bn_grads_local', 'running_var_local',
          'clip_norm_dp')
READINGS = ('first', 'all', 'val_first_rel', 'val_last_rel')


def seed_list(text):
    if '-' in text:
        lo, hi = map(int, text.split('-'))
        return list(range(lo, hi + 1))
    return [int(s) for s in text.split(',') if s]


@contextlib.contextmanager
def planted(name, norms):
    """The sharded step with the fault ``name`` (None: as it is), and
    every global gradient norm it computes appended to ``norms``."""
    import torch
    from nnueehcs_tpu_torch.nn.layers import _BatchNorm
    from nnueehcs_tpu_torch.training.sharded import ShardedTraining
    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, owner.__dict__[attr]))
        setattr(owner, attr, value)

    sync, sq_norm = ShardedTraining.sync_grads, ShardedTraining.sq_norm

    def recorded(self, grads):
        total = sq_norm(self, grads)
        if name == 'clip_norm_dp':
            total = self.mesh.all_reduce(torch.as_tensor(total), 'dp')
        norms.append(float(torch.sqrt(torch.as_tensor(total))))
        return total
    patch(ShardedTraining, 'sq_norm', recorded)
    if name == 'grad_mean':
        patch(ShardedTraining, 'sync_grads', lambda self, grads: [
            g / self.mesh.axis_size('dp') for g in sync(self, grads)])
    elif name == 'bn_grads_local':
        def local_bn(self, grads):
            bn = {id(p) for layer in self.net.layers
                  if isinstance(layer, _BatchNorm)
                  for p in layer.parameters()}
            return [g if id(p) in bn and g is not None else o
                    for p, g, o in zip(self.params, grads,
                                       sync(self, grads))]
        patch(ShardedTraining, 'sync_grads', local_bn)
    elif name == 'running_var_local':
        patch(_BatchNorm, '_batch_count', lambda self, x, dims: math.prod(
            x.shape[d] for d in dims))
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)


def fit_rank(rank, mesh, devices, seeds, plants, plant_seeds, log_dir):
    """Rank ``rank``'s fits; rank 0 returns the readings."""
    import torch
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.DEVICE = devices[rank]
    lead = rank == 0
    out = []

    def reading(seed, axes, plant, ref):
        norms = []
        with planted(plant, norms):
            trainer, losses, vals, _, seconds = cs.parallel_fit(
                cs.build_model(seed), x, y, seed,
                os.path.join(log_dir, plant or 'clean'), mesh=axes,
                devices=devices)
        if not lead:
            return
        out.append({'seed': seed, 'mesh': str(axes), 'plant': plant,
                    'steps': len(losses), **cs.fit_readings(losses, vals,
                                                            *ref),
                    'val_losses': vals, 'unsharded_val_losses': ref[1],
                    'max_grad_norm': max(norms), 'seconds': seconds})
        print(json.dumps(out[-1]), flush=True)

    for seed in sorted(set(seeds) | set(plant_seeds)):
        x, y = cs.parallel_fit_data(seed)
        ref = None
        if lead:
            _, ref_losses, ref_vals, _, _ = cs.parallel_fit(
                cs.build_model(seed), x, y, seed,
                os.path.join(log_dir, 'unsharded'))
            ref = (ref_losses, ref_vals)
        if seed in seeds:
            reading(seed, {'dp': mesh.size}, None, ref)
            reading(seed, {'member': mesh.size}, None, ref)
        if seed in plant_seeds:
            for plant in plants:
                reading(seed, {'dp': mesh.size}, plant, ref)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--seeds', type=seed_list, default=seed_list('0-4'))
    parser.add_argument('--plant-seeds', type=seed_list,
                        default=seed_list('0-1'))
    parser.add_argument('--plants', default='all',
                        help="comma-separated names of PLANTS, 'all' or ''")
    parser.add_argument('--device', default='cuda:0')
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)
    plants = list(PLANTS) if args.plants == 'all' else \
        [p for p in args.plants.split(',') if p]
    unknown = set(plants) - set(PLANTS)
    if unknown:
        parser.error(f'unknown plants {sorted(unknown)}; the plants are '
                     f'{PLANTS}')
    sys.path.insert(0, ROOT)
    import torch
    from nnueehcs_tpu_torch.attrib import nvidia_smi
    from nnueehcs_tpu_torch.parallel import launch
    if args.device != 'cpu' and not torch.cuda.is_available():
        print('parallel_fit_bars: no CUDA card', file=sys.stderr)
        return 2
    devices = [args.device] * 2
    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    log_dir = tempfile.mkdtemp(dir=os.path.join(ROOT, 'build'),
                               prefix='parallel_fit_bars_')
    start = time.perf_counter()
    try:
        records = launch(fit_rank, 2, backend='gloo', devices=devices,
                         timeout=3000, threads=4 if args.device == 'cpu'
                         else None,
                         args=(devices, args.seeds, plants, args.plant_seeds,
                               log_dir))
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    summary = {'seconds': time.perf_counter() - start}
    for mesh in ("{'dp': 2}", "{'member': 2}"):
        clean = [r for r in records if r['mesh'] == mesh and not r['plant']]
        summary[f'clean {mesh}'] = {k: max(r[k] for r in clean)
                                    for k in READINGS + ('max_grad_norm',)}
    for plant in plants:
        mine = [r for r in records if r['plant'] == plant]
        summary[plant] = {k: min(r[k] for r in mine) for k in READINGS}
    if args.out:
        with open(args.out, 'w') as f:
            for r in records:
                f.write(json.dumps(r) + '\n')
    print(json.dumps(summary), flush=True)
    if args.device != 'cpu':
        print(nvidia_smi('name,power.limit'), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
