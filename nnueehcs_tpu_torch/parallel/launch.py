"""Run one function on every rank of a new process group.

The JAX package has no counterpart: one JAX process drives every device.
The port runs one process per rank, and :func:`launch` is how a caller in
one process gets such a world: it spawns ``world`` processes (start method
``spawn``), each initialises the default group over a ``tcp://`` store on
``localhost``, makes the ``{'dp': world}`` mesh and calls ``fn(rank,
mesh, *args)``; the caller gets rank 0's result, or every rank's.

``fn`` and ``args`` are pickled: ``fn`` must be a module-level function
of a module that a fresh interpreter can import, and that module must not
import JAX (a spawned child imports the module of its target). A rank
that raises, or a world that outlives ``timeout``, ends every rank; the
first failure is raised in the caller with the rank's traceback as its
cause. Five seconds before the timeout each rank still running writes its
threads' stacks to its standard error.
"""
from __future__ import annotations

import faulthandler
import math
import multiprocessing as mp
import pickle
import queue
import socket
import time
import traceback
from datetime import timedelta

from .mesh import make_mesh
from .multihost import DEFAULT_TIMEOUT, initialize, shutdown


class RemoteTraceback(Exception):
    """The traceback of a rank's exception, as text."""

    def __str__(self):
        return self.args[0]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, devices, threads,
               group_timeout, dump_at, fn, args, results):
    try:
        if dump_at is not None:
            # a rank still running when the world times out shows where
            faulthandler.dump_traceback_later(max(dump_at - time.time(), 1.0))
        import torch
        if threads is not None:
            torch.set_num_threads(threads)
        initialize(f'127.0.0.1:{port}', world, rank, backend,
                   timeout=group_timeout)
        mesh = make_mesh({'dp': world}, devices, timeout=group_timeout)
        if mesh.device is not None and mesh.device.type == 'cuda':
            torch.cuda.set_device(mesh.device)
        results.put((rank, True, fn(rank, mesh, *args)))
    except BaseException as e:  # noqa: BLE001 (reported to the caller)
        text = traceback.format_exc()
        try:
            exc = pickle.loads(pickle.dumps(e))
        except Exception:  # noqa: BLE001 (an exception that will not pickle)
            exc = None
        results.put((rank, False, (exc, text)))
    finally:
        shutdown()


def launch(fn, world: int, backend: str = 'gloo', devices=None,
           timeout: float = 600.0, args=(), all_ranks=False,
           threads=None, group_timeout: timedelta = DEFAULT_TIMEOUT):
    """Run ``fn(rank, mesh, *args)`` on ``world`` new processes, one a
    rank, over ``backend`` (``'gloo'`` or ``'nccl'``), rank ``r`` on
    ``devices[r]`` (default: ``make_mesh``'s), in the mesh ``{'dp':
    world}`` (a rank body makes any other mesh with ``make_mesh``).
    ``threads`` sets each rank's torch threads. Returns rank 0's result,
    or the list of every rank's with ``all_ranks``. Raises the first rank's exception (its traceback the
    cause), or ``TimeoutError`` after ``timeout`` seconds (None: no
    limit); either way every rank is ended."""
    if world < 1:
        raise ValueError(f'a world needs at least one rank, got {world}')
    ctx = mp.get_context('spawn')
    results = ctx.Queue()
    port = free_port()
    # the ranks' stack dumps, on the wall clock all processes share
    dump_at = None if timeout is None else time.time() + timeout - 5.0
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(rank, world, port, backend,
              None if devices is None else [str(d) for d in devices],
              threads, group_timeout, dump_at, fn, tuple(args),
              results))
        for rank in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = math.inf if timeout is None else time.monotonic() + timeout
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f'{world} ranks of {fn.__name__} did not '
                                   f'finish within {timeout} s')
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                # nothing came for a second: a rank that has ended without
                # a result will not send one
                for r, p in enumerate(procs):
                    if r not in got and p.exitcode is not None:
                        raise RuntimeError(f'rank {r} of {fn.__name__} exited '
                                           f'with code {p.exitcode} and no '
                                           'result')
                continue
            if not ok:
                exc, text = payload
                cause = RemoteTraceback(f'rank {rank}:\n{text}')
                if exc is None:
                    raise RuntimeError(f'rank {rank} of {fn.__name__} '
                                       'failed') from cause
                raise exc from cause
            got[rank] = payload
    finally:
        for p in procs:
            if p.is_alive() and len(got) < world:
                p.kill()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [got[r] for r in range(world)] if all_ranks else got[0]
