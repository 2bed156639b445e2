"""Deep ensemble with a stacked member axis.

Counterpart of ``nnueehcs_tpu/models/ensemble.py``, evaluation side. The
members live as a leading axis on every parameter of one network. A UE pass
folds BatchNorm into the Linear weights once per parameter version and runs
:func:`~nnueehcs_tpu_torch.ops.fused_ensemble.fused_forward_prefolded`: the
CUDA kernel on the card, its plain version on the CPU. A network that the
TPU kernel does not take either (a Dropout layer, a layer output over 128
wide) runs member by member through the modules, as the JAX package's vmap
path does.
"""
from __future__ import annotations

from ..ops.fused_ensemble import fused_forward_prefolded, prepare_fused_weights
from .base import WrappedModelBase


class EnsembleModel(WrappedModelBase):
    uq_method = 'ensemble'

    def __init__(self, net, num_models: int, **kwargs):
        if net.members != num_models:
            raise ValueError(f'network stacks {net.members} members, '
                             f'expected num_models={num_models}')
        super().__init__(net, **kwargs)
        self.num_models = num_models
        self._fused = None
        self._fused_key = None

    def _params_key(self):
        # data_ptr changes when tensors move or are replaced, _version on
        # every in-place write (load_arrays, optimiser steps)
        return tuple((t.data_ptr(), t._version)
                     for t in (*self.net.parameters(), *self.net.buffers()))

    def fused_weights(self):
        """The folded, packed weights for the current parameters and BN
        state (None when the network does not fit the kernel), rebuilt when
        either changes."""
        key = self._params_key()
        if key != self._fused_key:
            self._fused = prepare_fused_weights(self.net)
            self._fused_key = key
        return self._fused

    def eval_output(self, x, return_ue: bool = False):
        fw = self.fused_weights()
        if fw is not None:
            mean, std = fused_forward_prefolded(fw, x)
        else:
            outputs = self.net(x)                     # (M, B, out)
            mean = outputs.mean(0)
            std = outputs.std(0, correction=1)
        return (mean, std) if return_ue else mean

    def config_dict(self):
        d = super().config_dict()
        d['num_models'] = self.num_models
        return d
