"""Profiling helpers (counterpart of ``nnueehcs_tpu/utils/profiling.py``).

The metrics themselves are measured in-band (:mod:`..evaluation`); this
module adds a ``torch.profiler`` trace of a region, written as a Chrome
trace (``chrome://tracing`` or Perfetto), named spans inside it, and the
CUDA caching allocator's statistics. Each takes the device it is about
(default the card, which must exist; ``'cpu'`` only when asked). On a CUDA
device the trace records the device's kernels through CUPTI: where CUPTI
is missing the trace holds no kernel, and a caller that needs one checks
for it (``chip_smoke.py`` does).
"""
from __future__ import annotations

import contextlib
import os

import torch

from ..models.base import resolve_device

TRACE_FILE = 'trace.json'


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True, device='cuda'):
    """``with profile_trace('logs/profile') as prof: ...`` profiles the
    region with the CPU activity, and the CUDA one on a CUDA ``device``,
    and writes ``<log_dir>/trace.json`` when it ends. Yields the profiler
    (None when not ``enabled``)."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if resolve_device(device).type == 'cuda':
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str, device='cuda'):
    """A named span: a ``record_function`` range in a profile and, on a
    CUDA ``device``, an NVTX range."""
    cuda = resolve_device(device).type == 'cuda'
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if cuda:
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


def device_memory_stats(device='cuda') -> dict:
    """The CUDA caching allocator's statistics for ``device``; ``{}`` for
    the CPU, which has no such allocator."""
    dev = resolve_device(device)
    if dev.type == 'cpu':
        return {}
    return dict(torch.cuda.memory_stats(dev))


def live_array_bytes(device='cuda') -> int:
    """Bytes of live tensors that the CUDA caching allocator holds on
    ``device``. The CPU keeps no such count: asking for it raises."""
    dev = resolve_device(device)
    if dev.type != 'cuda':
        raise ValueError(f'live_array_bytes: {dev} has no allocator '
                         'statistics; it counts CUDA tensors only')
    return int(torch.cuda.memory_allocated(dev))
