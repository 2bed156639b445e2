"""Every committed ``model.pth`` bundle through both packages on the CPU:
prints, per class, how many bundles ran and the worst prediction and UE
error as a share of the parity bars of tests/test_torch_committed_bundles.py
(1.0 is at the bar), then each bundle above half a bar. For a KDE or Δ-UQ
bundle above a whole bar it also prints each package's largest distance
from a float64 evaluation (the KDE log density; the Δ-UQ spread through
the modules in float64), which tells float32 round-off shared by both
packages from a fault of one. MC-dropout bundles are skipped: their masks
differ by design and tests/test_torch_committed_bundles.py holds one of
them statistically.

    python tests/torch_bundle_sweep.py [--rows 256]

Not collected by pytest (it takes about a minute); the tier-1 tests run one
bundle per class.
"""
import argparse
import glob
import os
import pickle
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from nnueehcs_tpu.training import load_model as jax_load_model  # noqa: E402
from nnueehcs_tpu_torch.training import load_model  # noqa: E402

from test_torch_committed_bundles import (EXPERIMENTS, TOL_UE,  # noqa: E402
                                          logpdf_f64, rows_for)
from torch_parity import TOL_MEAN  # noqa: E402


def share(got, want, tol):
    return float(np.max(np.abs(got - want)
                        / (tol['atol'] + tol['rtol'] * np.abs(want))))


def float64_distances(jm, pm, x):
    """(port, JAX) largest distance from a float64 evaluation of the KDE
    log density or the Δ-UQ spread; None for other classes."""
    if pm.uq_method == 'kde':
        ref = logpdf_f64(x, pm.kde.data.numpy(), pm.kde.bandwidth_)
        return (np.abs(pm.kde.score_samples(x).numpy() - ref).max(),
                np.abs(np.asarray(jm.kde.score_samples(x)) - ref).max())
    if pm.uq_method == 'delta_uq':
        got = pm(x, return_ue=True)[1].numpy()
        want = np.asarray(jm(x, return_ue=True)[1])
        pm.net.double()
        with torch.no_grad():
            _, ref = pm.anchored_stats_modules(
                torch.from_numpy(x).double(), pm.anchors.double(),
                pm.num_anchors)
        pm.net.float()
        ref = ref.numpy()
        return np.abs(got - ref).max(), np.abs(want - ref).max()
    return None


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--rows', type=int, default=256)
    args = parser.parse_args()
    worst, notes = {}, []
    for path in sorted(glob.glob(os.path.join(EXPERIMENTS, '**', 'model.pth'),
                                 recursive=True)):
        if not os.path.isfile(path):
            continue
        with open(path, 'rb') as f:
            cls = pickle.load(f)['config']['class']
        if cls not in TOL_UE:
            continue
        jm, pm = jax_load_model(path), load_model(path, device='cpu')
        x = rows_for(pm, args.rows)
        got = [t.numpy() for t in pm(x, return_ue=True)]
        want = [np.asarray(t) for t in jm(x, return_ue=True)]
        shares = (share(got[0], want[0], TOL_MEAN),
                  share(got[1], want[1], TOL_UE[cls]))
        entry = worst.setdefault(cls, [0, 0.0, 0.0])
        entry[0] += 1
        entry[1], entry[2] = max(entry[1], shares[0]), max(entry[2], shares[1])
        name = os.path.relpath(path, EXPERIMENTS)
        if max(shares) > 0.5:
            notes.append(f'{name}: mean share {shares[0]:.3f}, '
                         f'ue share {shares[1]:.3f}')
        distances = float64_distances(jm, pm, x) if shares[1] > 1 else None
        if distances is not None:
            notes.append(f'  from float64: port {distances[0]:.3e}, '
                         f'JAX {distances[1]:.3e}')
    for cls, (count, mean_share, ue_share) in sorted(worst.items()):
        print(f'{cls}: {count} bundles, worst mean share {mean_share:.3f}, '
              f'worst ue share {ue_share:.3f}')
    print('\n'.join(notes))


if __name__ == '__main__':
    main()
