"""Concurrent BO cells on device slices (counterpart of
``examples/bo_driven/mesh_workflow_driver.py``).

One process owns the devices; each (benchmark x uq_method x dataset split)
cell runs its full restartable BO loop on a slice leased from a queue, so
a fast cell's thread never starts the next cell on a slice another cell
still uses. A slice is a list of devices, cut as the JAX driver cuts them:
``cards // slices`` cards each (more slices than cards raises). A slice of
one card runs its trials there; a slice of several runs each trial on one
process a card, sharded over a dp mesh (``driver.run_bo_experiment(devices=)``).
With ``--device cpu`` each of ``--slices`` threads runs on the CPU::

    python -m nnueehcs_tpu_torch.examples.bo_driven.mesh_workflow_driver \\
        --config config.yaml --output results [--slices 2] [--device cpu]
"""
from __future__ import annotations

import argparse
import queue
import traceback
from concurrent.futures import ThreadPoolExecutor

import torch

from ... import config as config_reader
from ...driver import run_bo_experiment
from ...models.base import resolve_device
from .workflow_driver import grid


def device_slices(device, slices=None):
    """The slices, each a list of devices. On the cards, as the JAX driver
    cuts its devices: ``slices`` (default: one a card) slices of ``cards //
    slices`` cards each, in order; more slices than cards (the JAX driver
    cuts them down) and no card at all raise. On the CPU, ``slices``
    (default 1) threads share it, one ``'cpu'`` device each."""
    dev = resolve_device(device)
    if dev.type == 'cpu':
        return [['cpu'] for _ in range(slices or 1)]
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError(f'device {device!r}: no CUDA card is visible; '
                           'pass --device cpu to run on the CPU')
    if slices is not None and not 1 <= slices <= count:
        raise ValueError(f'--slices {slices}: {count} cards make 1 to '
                         f'{count} slices')
    n_slices = slices or count
    per = count // n_slices
    return [[f'cuda:{i * per + j}' for j in range(per)]
            for i in range(n_slices)]


def run_cells(cells, config_data, output, slices, retries=3):
    """Run every cell on a slice (a device, or a list of them) leased from a
    queue; returns
    ``[(benchmark, method, dataset, 'OK' or 'FAILED')]`` in ``cells``'
    order."""
    free_slices = queue.Queue()
    for i in range(len(slices)):
        free_slices.put(i)

    def run_cell(bench, method, dset):
        slice_idx = free_slices.get()
        try:
            for attempt in range(retries + 1):
                try:
                    devices = slices[slice_idx]
                    if isinstance(devices, str):
                        devices = [devices]
                    if len(devices) > 1:
                        run_bo_experiment(bench, method, config_data, dset,
                                          output, restart=True,
                                          devices=devices)
                    else:
                        run_bo_experiment(bench, method, config_data, dset,
                                          output, restart=True,
                                          device=devices[0])
                    return (bench, method, dset, 'OK')
                except Exception as e:  # noqa: BLE001 (retried, reported)
                    print(f'{bench}/{method}/{dset} attempt {attempt} '
                          f'failed: {e}')
                    traceback.print_exc()
            return (bench, method, dset, 'FAILED')
        finally:
            free_slices.put(slice_idx)

    with ThreadPoolExecutor(max_workers=len(slices)) as pool:
        futures = [pool.submit(run_cell, *cell) for cell in cells]
        return [fut.result() for fut in futures]


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Run BO cells concurrently on device slices.')
    parser.add_argument('--config', default='./config.yaml')
    parser.add_argument('--output', default='workflow_output')
    parser.add_argument('--slices', default=None, type=int,
                        help='Number of slices (= concurrent cells); '
                             'default: the card count (1 on the CPU)')
    parser.add_argument('--retries', default=3, type=int)
    parser.add_argument('--cells', default=None,
                        help='Comma-separated bench:method:dataset filter '
                             '(the syntax of workflow_driver); default: the '
                             'full benchmarks x uq_methods x splits product')
    parser.add_argument('--device', default='cuda',
                        help="'cpu' to run the slices on the CPU; default: "
                             'the cards')
    args = parser.parse_args(argv)
    config_data = config_reader.load_path(args.config)
    try:
        cells = grid(config_data, args.cells)
    except ValueError as e:
        parser.error(str(e))
    slices = device_slices(args.device, args.slices)
    per = len(slices[0])
    print(f'{len(slices)} slices of {per} device{"s" if per > 1 else ""}: '
          + ', '.join('+'.join(s) for s in slices))

    results = run_cells(cells, config_data, args.output, slices,
                        args.retries)
    for bench, method, dset, status in results:
        print(f'{bench}/{method}/{dset}: {status}')
    return 1 if any(r[3] != 'OK' for r in results) else 0


if __name__ == '__main__':
    raise SystemExit(main())
