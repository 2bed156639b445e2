"""BO-driven UQ hyperparameter search, one (benchmark x uq_method x
dataset split) cell (counterpart of ``examples/bo_driven/bo.py``).

A thin entry point over :func:`nnueehcs_tpu_torch.driver.main`, with the
JAX script's options and ``--device`` in place of ``--platform``::

    python -m nnueehcs_tpu_torch.examples.bo_driven.bo --benchmark minibude \\
        --uq_method ensemble --config config.yaml --dataset tails \\
        --output results [--restart] [--device cpu]
"""
from __future__ import annotations

import os

from ... import driver

# inherited SLURM CPU-binding state that a task fanned out by a scheduler
# must not pass on
SLURM_VARS = ('SLURM_CPU_BIND', 'SLURM_CPU_BIND_LIST', 'SLURM_CPUS_ON_NODE',
              'SLURM_CPUS_PER_TASK', 'SLURM_CPU_BIND_TYPE', 'SLURM_JOB_NAME')


def main(argv=None):
    for var in SLURM_VARS:
        os.environ.pop(var, None)
    return driver.main(argv)


if __name__ == '__main__':
    raise SystemExit(main())
