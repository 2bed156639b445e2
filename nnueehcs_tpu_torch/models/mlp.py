"""Plain MLP wrapper: passthrough forward, no uncertainty estimate
(counterpart of ``nnueehcs_tpu/models/mlp.py``)."""
from __future__ import annotations

from .base import WrappedModelBase


class MLPModel(WrappedModelBase):
    uq_method = 'mlp'

    # eval_output inherited: plain net pass, no UE.
