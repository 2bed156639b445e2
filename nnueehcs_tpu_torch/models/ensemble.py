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

On a mesh with a ``member`` axis of size ``m`` each rank holds
``num_models / m`` members, a slice of the stacked network (the count
must divide, as JAX's sharding requires). A UE pass runs the kernel on
the rank's members and merges each shard's mean and unbiased std over
``member`` by Chan's parallel-variance formula; a ``joint_mean`` loss
takes the mean over every member through a differentiable all-reduce.
The bundle (``arrays_dict``) gathers the members back.
"""
from __future__ import annotations

import torch

from ..nn.network import build_network
from ..ops.fused_ensemble import (fused_forward_prefolded,
                                  prepare_fused_weights, shifted_stats)
from ..parallel.mesh import all_reduce_grad
from .base import WrappedModelBase


def member_slice(net, lo: int, hi: int):
    """A stacked network of members ``lo .. hi - 1`` of ``net`` (copies)."""
    local = build_network(net.architecture, members=hi - lo).to(
        next(net.parameters()).device)
    local.load_state_dict({k: v[lo:hi] for k, v in net.state_dict().items()})
    local.compute_dtype = net.compute_dtype
    return local.train(net.training)


def gather_members(net, mesh, members: int):
    """The whole stacked network of ``members`` members from every rank's
    slice over ``mesh``'s ``member`` axis."""
    full = build_network(net.architecture, members=members).to(
        next(net.parameters()).device)
    full.load_state_dict({k: mesh.all_gather(v, 'member')
                          for k, v in net.state_dict().items()})
    full.compute_dtype = net.compute_dtype
    return full.train(net.training)


def merge_member_stats(mean, std, local: int, members: int, mesh):
    """Mean and unbiased std over ``members`` members from each rank's
    ``local`` members' ``(mean, std)``, by Chan's parallel variance: the
    global mean first, then every shard's sums shifted by it
    (``shifted_stats``)."""
    mu = mesh.all_reduce(mean * local, 'member') / members
    d = mean - mu
    # one member's std is NaN through the modules (0 / 0); its M2 is 0
    m2 = std * std * (local - 1) if local > 1 else torch.zeros_like(std)
    sums = mesh.all_reduce(torch.stack([local * d, m2 + local * d * d]),
                           'member')
    return shifted_stats(sums[0], sums[1], mu, members)


class EnsembleModel(WrappedModelBase):
    uq_method = 'ensemble'

    def __init__(self, net, num_models: int, **kwargs):
        if net.members != num_models:
            raise ValueError(f'network stacks {net.members} members, '
                             f'expected num_models={num_models}')
        super().__init__(net, **kwargs)
        self.num_models = num_models
        # (member axis size, this rank's index) while the net is a slice
        self._member_shard = None
        self._member_mesh = None

    def _per_member(self) -> bool:
        return self.train_config.get('ensemble_loss',
                                     'joint_mean') == 'per_member'

    # ------------------------------------------------------------ sharding
    def _shard_members(self):
        mesh = self._mesh
        m = 1 if mesh is None else mesh.axis_size('member')
        want = None if m == 1 else (m, mesh.axis_index('member'))
        if want == self._member_shard:
            return
        if self._member_shard is not None:
            self.net = gather_members(self.net, self._member_mesh,
                                      self.num_models)
            self._member_shard = self._member_mesh = None
        if want is None:
            return
        if self.num_models % m:
            raise ValueError(
                f'{self.num_models} ensemble members do not divide over the '
                f"mesh axis 'member' of size {m}: the global size of the "
                f'member dimension should be divisible by {m}, but it is '
                f'equal to {self.num_models}')
        per = self.num_models // m
        self.net = member_slice(self.net, want[1] * per, (want[1] + 1) * per)
        self._member_shard, self._member_mesh = want, mesh

    def full_net(self):
        """The network with every member (gathered over ``member`` when
        this rank holds a slice: every rank of the mesh must call it)."""
        if self._member_shard is None:
            return self.net
        return gather_members(self.net, self._member_mesh, self.num_models)

    def arrays_dict(self):
        net, self.net = self.net, self.full_net()
        try:
            return super().arrays_dict()
        finally:
            self.net = net

    # ------------------------------------------------------------ training
    def train_output(self, x, generator=None):
        outputs = self.net(x, generator)              # (M, B, out)
        if self._per_member():
            return outputs
        if self._member_shard is not None:
            return all_reduce_grad(outputs.sum(0), self._member_mesh,
                                   'member') / self.num_models
        return outputs.mean(0)

    def train_targets(self, y):
        if self._per_member():
            return y.expand((self.net.members,) + tuple(y.shape))
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
        if self._member_shard is not None:
            mean, std = merge_member_stats(mean, std, self.net.members,
                                           self.num_models, self._member_mesh)
        return (mean, std) if return_ue else mean

    def config_dict(self):
        d = super().config_dict()
        d['num_models'] = self.num_models
        return d
