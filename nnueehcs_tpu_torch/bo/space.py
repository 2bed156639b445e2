"""Search-space handling for the BO engine.

Counterpart of ``nnueehcs_tpu/bo/space.py`` (numpy only). The parameter
dicts follow the Ax schema of the configs
(``examples/bo_driven/config.yaml``)::

    {name: num_models, type: range,  bounds: [2, 32]}
    {name: anchored_batch_size, type: range, bounds: [64, 131072], log_scale: true}
    {name: estimator, type: fixed, value: 'std'}
    {name: bandwidth, type: choice, values: ['scott', 'silverman']}

Range parameters with integer bounds are integers (Ax convention). All
parameters map to the unit hypercube for the GP: ranges linearly (log-space
when ``log_scale``), choices by ordinal index; fixed params are excluded.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np


class ParameterSpace:
    def __init__(self, parameters: List[dict]):
        self.parameters = [dict(p) for p in parameters]
        self.tunable = [p for p in self.parameters if p['type'] != 'fixed']
        self.fixed = {p['name']: p['value']
                      for p in self.parameters if p['type'] == 'fixed'}

    @property
    def dim(self) -> int:
        return len(self.tunable)

    def names(self) -> List[str]:
        return [p['name'] for p in self.parameters]

    # --------------------------------------------------------- unit mapping
    def _is_int(self, p: dict) -> bool:
        if 'value_type' in p:
            return p['value_type'] == 'int'
        lo, hi = p['bounds']
        return isinstance(lo, int) and isinstance(hi, int) \
            and not isinstance(lo, bool)

    def from_unit(self, u: np.ndarray) -> Dict[str, Any]:
        """Map a point in [0,1]^dim to a concrete parameter dict."""
        out = dict(self.fixed)
        for i, p in enumerate(self.tunable):
            ui = float(np.clip(u[i], 0.0, 1.0))
            if p['type'] == 'choice':
                values = p['values']
                idx = min(int(ui * len(values)), len(values) - 1)
                out[p['name']] = values[idx]
            else:  # range
                lo, hi = p['bounds']
                if p.get('log_scale'):
                    val = math.exp(math.log(lo) + ui * (math.log(hi) - math.log(lo)))
                else:
                    val = lo + ui * (hi - lo)
                if self._is_int(p):
                    val = int(round(val))
                val = min(max(val, lo), hi)   # guard float rounding at bounds
                out[p['name']] = val
        return out

    def to_unit(self, params: Dict[str, Any]) -> np.ndarray:
        u = np.zeros(self.dim)
        for i, p in enumerate(self.tunable):
            v = params[p['name']]
            if p['type'] == 'choice':
                values = p['values']
                u[i] = (values.index(v) + 0.5) / len(values)
            else:
                lo, hi = p['bounds']
                if p.get('log_scale'):
                    u[i] = (math.log(v) - math.log(lo)) / \
                        (math.log(hi) - math.log(lo) + 1e-300)
                else:
                    u[i] = (v - lo) / (hi - lo + 1e-300)
        return np.clip(u, 0.0, 1.0)
