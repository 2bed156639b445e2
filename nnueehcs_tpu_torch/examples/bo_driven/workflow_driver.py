"""Fan the (benchmark x uq_method x dataset split) grid out as concurrent
restartable tasks (counterpart of ``examples/bo_driven/workflow_driver.py``).

Each cell runs as a subprocess of :mod:`.bo` with ``--restart``; a failed
task is retried up to ``workflow_config.retries`` times, resuming from the
per-trial state files. Two modes:

- a local pool (default) of ``--max_tasks`` (else
  ``workflow_config.max_concurrent_tasks``) cells at a time,
- ``--sbatch``: one sbatch script per cell from the ``bo_slurm_config``
  block, for SLURM clusters.

::

    python -m nnueehcs_tpu_torch.examples.bo_driven.workflow_driver \\
        --config config.yaml --output results [--cells b:m:d,...] \\
        [--device cpu] [--sbatch]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from itertools import product

from ... import config as config_reader
from .. import PACKAGE_ROOT, package_env
from .bo import SLURM_VARS

BO_MODULE = 'nnueehcs_tpu_torch.examples.bo_driven.bo'
SPLITS = ('tails', 'gaps')


def bo_command(config_path, benchmark, uq_method, dataset, output):
    return [sys.executable, '-m', BO_MODULE, '--benchmark', benchmark,
            '--config', config_path, '--uq_method', uq_method,
            '--dataset', dataset, '--output', output, '--restart']


def run_bo_task(config_path, benchmark, uq_method, dataset, output,
                rundir, retries, device=None):
    """Run one cell until it succeeds or ``retries`` retries are spent,
    waiting 30 s doubling (at most 600 s) between attempts; its
    output is appended to ``<rundir>/<benchmark>_<uq_method>_<dataset>``
    ``.out``/``.err``. Returns ``(benchmark, uq_method, dataset, rc)``."""
    cmd = bo_command(config_path, benchmark, uq_method, dataset, output)
    if device:
        cmd += ['--device', device]
    os.makedirs(rundir, exist_ok=True)
    log_base = os.path.join(rundir, f'{benchmark}_{uq_method}_{dataset}')
    env = package_env(drop=SLURM_VARS)
    for attempt in range(retries + 1):
        with open(f'{log_base}.out', 'a') as out, \
                open(f'{log_base}.err', 'a') as err:
            out.write(f'--- attempt {attempt}: {" ".join(cmd)}\n')
            out.flush()
            rc = subprocess.run(cmd, stdout=out, stderr=err,
                                env=env).returncode
        if rc == 0:
            return (benchmark, uq_method, dataset, 0)
        if attempt < retries:
            backoff = min(30 * 2 ** attempt, 600)
            print(f'Task {benchmark}/{uq_method}/{dataset} failed '
                  f'(attempt {attempt}, rc={rc}); retrying with --restart '
                  f'in {backoff}s')
            time.sleep(backoff)
        else:
            print(f'Task {benchmark}/{uq_method}/{dataset} failed '
                  f'(attempt {attempt}, rc={rc}); retries exhausted')
    return (benchmark, uq_method, dataset, rc)


def emit_sbatch_scripts(config_data, config_path, total, output, rundir):
    slurm = dict(config_data.get('bo_slurm_config', {}))
    os.makedirs(rundir, exist_ok=True)
    scripts = []
    for bench, uq_method, dset in total:
        name = f'{bench}_{uq_method}_{dset}'
        path = os.path.join(rundir, f'{name}.sbatch')
        with open(path, 'w') as f:
            f.write('#!/bin/bash\n')
            if 'partition' in slurm:
                f.write(f'#SBATCH --partition={slurm["partition"]}\n')
            if 'account' in slurm:
                f.write(f'#SBATCH --account={slurm["account"]}\n')
            if 'walltime' in slurm:
                f.write(f'#SBATCH --time={slurm["walltime"]}\n')
            f.write(f'#SBATCH --nodes={slurm.get("nodes", 1)}\n')
            f.write(f'#SBATCH --ntasks-per-node='
                    f'{slurm.get("ntasks_per_node", 1)}\n')
            f.write(f'#SBATCH --job-name={name}\n')
            f.write(f'PYTHONPATH={PACKAGE_ROOT}${{PYTHONPATH:+:$PYTHONPATH}} '
                    + ' '.join(bo_command(config_path, bench, uq_method,
                                          dset, output)) + '\n')
        scripts.append(path)
    return scripts


def parse_cells(spec, config_data):
    """``benchmark:uq_method:dataset`` triples, comma-separated, checked
    against the config; raises ValueError naming the first bad one."""
    benches = list(config_data['benchmarks'])
    uq_methods = list(config_data['uq_methods'])
    total = []
    for cell in spec.split(','):
        parts = cell.strip().split(':')
        if len(parts) != 3:
            raise ValueError(f'cell {cell!r} is not '
                             'benchmark:uq_method:dataset')
        b, m, d = parts
        if b not in benches:
            raise ValueError(f'unknown benchmark {b!r} (config has '
                             f'{benches})')
        if m not in uq_methods:
            raise ValueError(f'unknown uq_method {m!r} (config has '
                             f'{uq_methods})')
        if d not in SPLITS:
            raise ValueError(f'unknown dataset split {d!r}')
        total.append((b, m, d))
    return total


def grid(config_data, cells=None):
    """The cells to run: ``cells`` in its order, else the full benchmarks
    x uq_methods x splits product."""
    if cells:
        return parse_cells(cells, config_data)
    return list(product(config_data['benchmarks'],
                        config_data['uq_methods'], SPLITS))


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Run the BO grid as restartable subprocess tasks.')
    parser.add_argument('--config', default='./config.yaml',
                        help='Path to the config file')
    parser.add_argument('--output', default='workflow_output',
                        help='Path to the output directory.')
    parser.add_argument('--rundir', '--parsl_rundir', dest='rundir',
                        default='./rundir',
                        help='Path to the task log/run directory')
    parser.add_argument('--max_tasks', default=None, type=int,
                        help='Max concurrent tasks (default from '
                             'workflow_config)')
    parser.add_argument('--sbatch', action='store_true',
                        help='Emit sbatch scripts instead of running locally')
    parser.add_argument('--device', default=None,
                        help="the tasks' device: 'cpu' to run on the CPU; "
                             "default: the card, unless the config's "
                             'trainer names accelerator: cpu')
    parser.add_argument('--cells', default=None,
                        help='Comma-separated benchmark:uq_method:dataset '
                             'triples; runs exactly these cells in the given '
                             'order instead of the full product')
    args = parser.parse_args(argv)
    config_data = config_reader.load_path(args.config)
    try:
        total = grid(config_data, args.cells)
    except ValueError as e:
        parser.error(str(e))

    wf_cfg = config_data.get('workflow_config', {})
    retries = wf_cfg.get('retries', 20)
    workers = args.max_tasks or wf_cfg.get('max_concurrent_tasks', 2)

    if args.sbatch:
        for script in emit_sbatch_scripts(config_data, args.config, total,
                                          args.output, args.rundir):
            print(f'sbatch {script}')
        return 0

    print(f'Running {len(total)} tasks with {workers} workers, '
          f'{retries} retries each')
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futures = [pool.submit(run_bo_task, args.config, b, m, d,
                               args.output, args.rundir, retries,
                               args.device)
                   for b, m, d in total]
        results = [fut.result() for fut in futures]

    for b, m, d, rc in results:
        print(f'{b}/{m}/{d}: {"OK" if rc == 0 else f"FAILED rc={rc}"}')
    return 1 if any(r[3] != 0 for r in results) else 0


if __name__ == '__main__':
    raise SystemExit(main())
