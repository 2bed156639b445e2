"""Process-group initialisation.

Counterpart of ``nnueehcs_tpu/parallel/multihost.py``. Where JAX
initialises its distributed runtime once and then sees every device of
every host, the port initialises the default ``torch.distributed``
process group once per process: one process per rank, on one host or
several, and :func:`~nnueehcs_tpu_torch.parallel.mesh.make_mesh` lays its
axes over those ranks.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import DEFAULT_TIMEOUT


def default_backend() -> str:
    """NCCL where the process sees a card, gloo otherwise."""
    return 'nccl' if torch.cuda.is_available() else 'gloo'


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout: timedelta = DEFAULT_TIMEOUT) -> None:
    """Initialise the default process group.

    With explicit values, ``coordinator_address`` (``host:port`` of rank
    0's store) becomes a ``tcp://`` init method with ``num_processes``
    ranks, this one ``process_id``. With none, the group reads
    ``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK``, as torchrun and SLURM wrappers set them. ``backend`` defaults
    to :func:`default_backend`. A second call is a no-op, as in JAX.
    """
    if dist.is_initialized():
        return
    backend = backend or default_backend()
    if coordinator_address is None:
        init = 'env://'
        world = int(os.environ['WORLD_SIZE']) if num_processes is None \
            else num_processes
        rank = int(os.environ['RANK']) if process_id is None else process_id
    else:
        if num_processes is None or process_id is None:
            raise ValueError('coordinator_address needs num_processes and '
                             'process_id')
        address = coordinator_address
        if '://' not in address:
            address = f'tcp://{address}'
        init, world, rank = address, num_processes, process_id
    if backend == 'nccl':
        # the communicators start at the first collective, after make_mesh
        # has refused ranks that would share a card
        local = int(os.environ.get('LOCAL_RANK', rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, timeout=timeout)


def is_multihost() -> bool:
    """True when the process group holds more than one process."""
    return dist.is_initialized() and dist.get_world_size() > 1


def process_info() -> dict:
    """The four keys of the JAX package's ``process_info``: this process's
    index and the process count, and the devices it owns and the group
    holds (one a rank)."""
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    return {'process_index': rank, 'process_count': world,
            'local_devices': 1, 'global_devices': world}


def shutdown() -> None:
    """Destroy the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
