"""Deep ensemble with a stacked member axis.

Counterpart of ``nnueehcs_tpu/models/ensemble.py``. Training: every member
trains through the loss of the mean prediction (``ensemble_loss:
joint_mean``, the default) or through its own (``per_member``). The
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

    def _per_member(self) -> bool:
        return self.train_config.get('ensemble_loss',
                                     'joint_mean') == 'per_member'

    def train_output(self, x, generator=None):
        outputs = self.net(x, generator)              # (M, B, out)
        return outputs if self._per_member() else outputs.mean(0)

    def train_targets(self, y):
        if self._per_member():
            return y.expand((self.num_models,) + tuple(y.shape))
        return y

    def fused_weights(self):
        """The folded, packed weights for the current parameters and BN
        state (None when the network does not fit the kernel), rebuilt when
        either changes."""
        return self._folded_weights(prepare_fused_weights)

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
