"""Device timing (counterpart of ``nnueehcs_tpu/utils/timing.py``).

CUDA work is asynchronous, so a host clock around it measures only the
enqueue unless the device is synchronised first. ``timed_passes`` is the
reference's protocol: warm-up passes, then timed passes, each synchronised.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch


def device_sync(out):
    """Block until ``out`` (a tensor, or a tuple of tensors on one device)
    has been computed; return ``out``. Host values pass through."""
    first = out[0] if isinstance(out, tuple) else out
    if isinstance(first, torch.Tensor) and first.is_cuda:
        torch.cuda.synchronize(first.device)
    return out


def timed_passes(fn: Callable[[], object], num_warmup: int, num_trials: int):
    """Run ``fn`` ``num_warmup`` times, then time ``num_trials`` runs one by
    one; returns the per-run seconds."""
    for _ in range(num_warmup):
        device_sync(fn())
    times = np.zeros(num_trials)
    for i in range(num_trials):
        start = time.perf_counter()
        device_sync(fn())
        times[i] = time.perf_counter() - start
    return times
