"""Serving: a bucketed UQ predictor.

Counterpart of ``nnueehcs_tpu/serving.py``. The predictor loads a bundle
(or takes a model), places it on ``device``, warms every batch bucket once,
pads each request to the nearest bucket by repeating its first row, chunks
requests larger than the largest bucket, and trims the answers. Forward
passes are row-independent, so padding changes no answer. A model in
bf16-mixed (``set_precision``, or a bundle's ``train_config``) serves as
it is, its warm-up building and folding for that precision; the answers
are fp32 in either precision.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from .models.base import resolve_device
from .nn.layers import Linear
from .training.checkpoint import load_model
from .utils.timing import device_sync

DEFAULT_BUCKETS = (256, 1024, 4096, 16384, 65536)


class Predictor:
    def __init__(self, model_or_path, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 return_ue: bool = True, device='cuda', warmup: bool = True):
        device = resolve_device(device)
        if isinstance(model_or_path, str):
            self.model = load_model(model_or_path, device=device)
        else:
            self.model = model_or_path.to(device)
        self.return_ue = return_ue
        self.buckets = tuple(sorted(buckets))
        self._num_features = self._infer_features()
        if warmup:
            self.warmup()

    def _infer_features(self) -> Optional[int]:
        first = next((l for l in self.model.net.layers
                      if isinstance(l, Linear)), None)
        if first is None:
            return None
        if self.model.uq_method in ('delta_uq', 'pager'):
            return first.in_features // 2   # the anchored input doubles it
        return first.in_features

    @property
    def num_features(self):
        return self._num_features

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _run_bucket(self, chunk: np.ndarray):
        """One exactly-bucket-sized forward through the model."""
        return self.model(torch.from_numpy(chunk), return_ue=self.return_ue)

    def warmup(self) -> float:
        """Drive one forward per bucket, so first-use set-up (the kernel
        build, the weight fold) is paid before the first request. Returns
        the seconds it took."""
        start = time.perf_counter()
        for b in self.buckets:
            zeros = np.zeros((b, self._num_features), np.float32)
            device_sync(self._run_bucket(zeros))
        return time.perf_counter() - start

    def predict(self, x):
        """``(pred, ue)`` (or just ``pred`` when ``return_ue=False``) as
        numpy arrays."""
        x = np.asarray(x, dtype=np.float32)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None]
        n = x.shape[0]
        out_chunks = []
        pos = 0
        while pos < n:
            take = min(n - pos, self.buckets[-1])
            bucket = self._bucket(take)
            chunk = x[pos:pos + take]
            if take < bucket:
                chunk = np.concatenate(
                    [chunk, np.broadcast_to(chunk[:1],
                                            (bucket - take,) + chunk.shape[1:])])
            out = self._run_bucket(np.ascontiguousarray(chunk))
            if isinstance(out, tuple):
                out_chunks.append(tuple(o[:take].cpu().numpy() for o in out))
            else:
                out_chunks.append(out[:take].cpu().numpy())
            pos += take

        if isinstance(out_chunks[0], tuple):
            merged = tuple(np.concatenate([c[i] for c in out_chunks])
                           for i in range(len(out_chunks[0])))
        else:
            merged = np.concatenate(out_chunks)

        def trim(o):
            return o[0] if squeeze else o
        if isinstance(merged, tuple):
            return tuple(trim(o) for o in merged)
        return trim(merged)
