"""Training steps split over a mesh (``Trainer`` with a ``mesh`` of more
than one rank).

The JAX trainer shards a step by annotating its batch and parameters and
lets XLA's partitioner keep the mathematics of the unsharded step. The port
runs one process per rank, and this module restores that transparency by
hand, so that a sharded fit follows the unsharded per-step fit:

- **dp**: every rank draws the same global permutation and takes its
  contiguous rows of each global batch (``parallel.mesh.local_rows``). The
  loss a rank backpropagates is its rows' share of the global mean (its
  rows' mean times ``rows / batch``); parameter gradients are summed over
  ``dp``. BatchNorm takes its batch moments over the global batch
  (``BatchReduce``, a differentiable all-reduce), and its running
  statistics move from them. A Dropout draws the global batch's mask and
  keeps this rank's rows.
- **member**: an ensemble's members are split (the model's
  ``attach_mesh``); a ``joint_mean`` loss is formed from the all-reduced
  member sum, so it is the same on every member rank, and each such rank
  takes ``1 / member`` of it. Parameters that every member rank holds (a
  model without a member axis) have their gradients summed over
  ``member``.
- **tp**: each Linear whose output width divides holds its rank's block of
  output features (weight rows, bias), and so does a BatchNorm right after
  it; elementwise layers run on the block, and an all-gather over ``tp``
  (differentiable) restores the features before any other layer and at
  the end. Each tp rank takes ``1 / tp`` of the loss; the gradients of
  unsplit parameters are summed over ``tp``.

Clipping uses the global norm: each parameter's squared norm is summed
over the axes that split it (never over the axes that replicate it). Adam
then runs on each rank's own tensors.
"""
from __future__ import annotations

import copy
import math

import torch

from ..nn.layers import (ELU, GELU, BatchNorm1d, Dropout, Flatten, Identity,
                         LeakyReLU, Linear, ReLU, SiLU, Sigmoid, Softplus,
                         Tanh, _BatchNorm)
from ..nn.network import build_network
from ..parallel.mesh import all_gather_grad, all_reduce_grad, local_rows

# layers that run on a block of features as they run on all of them
_FEATURE_LOCAL = (BatchNorm1d, ReLU, Tanh, Sigmoid, GELU, SiLU, ELU,
                  LeakyReLU, Softplus, Identity)
_AXES = ('dp', 'member', 'tp')


class BatchReduce:
    """A BatchNorm's batch moments over the ``dp`` ranks: sums all-reduced
    through a differentiable collective."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.counts = {}          # this step's global counts by local count

    def count(self, n: int) -> int:
        if n not in self.counts:
            t = torch.tensor([float(n)], dtype=torch.float64,
                             device=self.mesh.device)
            self.counts[n] = int(self.mesh.all_reduce(t, 'dp').item())
        return self.counts[n]

    def mean(self, t, dims):
        n_local = math.prod(t.shape[d] for d in dims)
        return all_reduce_grad(t.sum(dims), self.mesh, 'dp') \
            / self.count(n_local)


class NetShard:
    """The forward of a network whose batch rows (``rows``, set for each
    step) or features (``tp_out``: which layers' outputs are split over
    ``tp``) are split over the mesh."""

    def __init__(self, mesh, tp_out, member_first: int, members):
        self.mesh = mesh
        self.tp_out = tp_out
        self.member_first = member_first
        self.members = members
        self.rows = None          # (global rows, this rank's row indices)

    def _gather(self, x):
        return all_gather_grad(x, self.mesh, 'tp', dim=x.dim() - 1)

    def forward(self, net, x, generator=None):
        cd = net.compute_dtype
        out_dtype = None
        if cd is not None and x.is_floating_point() and x.dtype != cd:
            out_dtype = x.dtype
            x = x.to(cd)
        stacked = split = False
        for i, (layer, adds) in enumerate(zip(net.layers,
                                              net._adds_member_axis)):
            if split and not isinstance(layer, _FEATURE_LOCAL):
                x, split = self._gather(x), False
            if isinstance(layer, Dropout):
                rows = None
                if self.rows is not None:
                    total, index = self.rows
                    rows = (1 if stacked else 0, total, index, self.members,
                            self.member_first)
                x = layer(x, generator, rows)
            elif isinstance(layer, Flatten):
                x = layer(x, stacked)
            else:
                x = layer(x)
            stacked = stacked or adds
            split = split or self.tp_out[i]
        if split:
            x = self._gather(x)
        return x if out_dtype is None else x.to(out_dtype)


def _block(t, dim: int, parts: int, index: int):
    width = t.shape[dim] // parts
    return t.narrow(dim, index * width, width)


def tp_plan(net, tp: int):
    """For each layer: ``'linear'`` (output features split over ``tp``),
    ``'norm'`` (a BatchNorm on split features) or None (whole)."""
    plan, split = [], False
    for block, layer in zip(net.architecture, net.layers):
        body = next(iter(block.values())) or {}
        args = body.get('args', [])
        kind = None
        if isinstance(layer, Linear) and len(args) >= 2 \
                and layer.out_features % tp == 0:
            kind, split = 'linear', True
        elif isinstance(layer, BatchNorm1d) and split and args:
            kind = 'norm'
        elif not isinstance(layer, _FEATURE_LOCAL):
            split = False
        plan.append(kind)
    return plan


def tp_local_net(net, mesh, plan):
    """This rank's network under ``plan``: split layers built at their
    block's width and holding their block of ``net``'s tensors."""
    tp, index = mesh.axis_size('tp'), mesh.axis_index('tp')
    arch = copy.deepcopy(net.architecture)
    for block, kind in zip(arch, plan):
        body = next(iter(block.values()))
        if kind == 'linear':
            body['args'][1] //= tp
        elif kind == 'norm':
            body['args'][0] //= tp
    local = build_network(arch, members=net.members).to(
        next(net.parameters()).device)
    local.compute_dtype = net.compute_dtype
    with torch.no_grad():
        for kind, full, mine in zip(plan, net.layers, local.layers):
            for name, t in full.state_dict().items():
                if kind == 'linear':
                    t = _block(t, t.dim() - (2 if name == 'weight' else 1),
                               tp, index)
                elif kind == 'norm':
                    t = _block(t, t.dim() - 1, tp, index)
                mine.state_dict()[name].copy_(t)
    return local.train(net.training)


class ShardedTraining:
    """A model's training on a mesh of more than one rank. ``net`` is the
    network the steps train (the model's own, or its tp-local form,
    installed as ``model.net`` between :meth:`train_mode` and
    :meth:`eval_mode`); ``params`` its parameters."""

    def __init__(self, model, mesh, anchored: bool):
        self.model = model
        self.mesh = mesh
        self.anchored = anchored
        self.full_net = model.net
        tp = mesh.axis_size('tp')
        self.plan = tp_plan(self.full_net, tp) if tp > 1 \
            else [None] * len(self.full_net.layers)
        self.net = tp_local_net(self.full_net, mesh, self.plan) if tp > 1 \
            else self.full_net
        member_split = getattr(model, '_member_shard', None) is not None
        first = 0
        if member_split:
            first = mesh.axis_index('member') * self.net.members
        self.shard = NetShard(mesh, [k == 'linear' for k in self.plan], first,
                              getattr(model, 'num_models', None))
        self.params, self.split_axes = [], []
        for kind, layer in zip(self.plan, self.net.layers):
            for p in layer.parameters():
                axes = (('member',) if member_split else ()) \
                    + (('tp',) if kind is not None else ())
                self.params.append(p)
                self.split_axes.append(tuple(a for a in axes
                                             if mesh.axis_size(a) > 1))
        self.share = 1.0 / (mesh.axis_size('member') * tp)
        self.batch_reduce = BatchReduce(mesh) \
            if mesh.axis_size('dp') > 1 else None
        for layer in self.net.layers:
            if isinstance(layer, _BatchNorm):
                layer.batch_reduce = self.batch_reduce

    def train_mode(self):
        """Install the trained network in the model and its shard."""
        self.net.shard = self.shard
        self.model.net = self.net

    def eval_mode(self):
        """The whole network back in the model, with the trained values
        (gathered over ``tp``)."""
        self.net.shard = None
        self.shard.rows = None
        if self.net is not self.full_net:
            with torch.no_grad():
                for kind, full, mine in zip(self.plan, self.full_net.layers,
                                            self.net.layers):
                    dst = full.state_dict()
                    for name, t in mine.state_dict().items():
                        if kind == 'linear':
                            t = self.mesh.all_gather(
                                t, 'tp', t.dim() - (2 if name == 'weight'
                                                    else 1))
                        elif kind == 'norm':
                            t = self.mesh.all_gather(t, 'tp', t.dim() - 1)
                        dst[name].copy_(t)
        self.model.net = self.full_net

    def loss(self, x_train, y_train, idx, generator, anchor_perm=None):
        """This rank's share of the loss of the global batch ``idx``: its
        rows' loss times ``rows / batch``, over the member and tp ranks
        that compute the same loss."""
        batch = idx.shape[0]
        lo, hi = local_rows(batch, self.mesh)
        if self.batch_reduce is not None:
            self.batch_reduce.counts = {}
        mine = torch.arange(lo, hi, device=idx.device)
        if self.anchored:
            self.shard.rows = (2 * batch, torch.cat([mine, mine + batch]))
            loss = self.model.training_loss(
                (x_train[idx], y_train[idx]), generator, anchor_perm,
                rows=(lo, hi))
        else:
            self.shard.rows = (batch, mine)
            sel = idx[lo:hi]
            loss = self.model.training_loss((x_train[sel], y_train[sel]),
                                            generator)
        if hi == lo:                  # no rows here: the mean of none
            loss = torch.nan_to_num(loss, nan=0.0)
        return loss * ((hi - lo) / batch * self.share)

    def sync_grads(self, grads):
        """Each gradient summed over the axes that replicate its
        parameter: one all-reduce of the flattened gradients for each set
        of axes."""
        out = [torch.zeros_like(p) if g is None else g
               for p, g in zip(self.params, grads)]
        groups = {}
        for i, split in enumerate(self.split_axes):
            axes = tuple(a for a in _AXES
                         if a not in split and self.mesh.axis_size(a) > 1)
            if axes:
                groups.setdefault(axes, []).append(i)
        for axes, idx in groups.items():
            flat = self.mesh.all_reduce(
                torch.cat([out[i].reshape(-1) for i in idx]), axes)
            for i, part in zip(idx, flat.split([out[i].numel()
                                                for i in idx])):
                out[i] = part.view_as(out[i])
        return out

    def sq_norm(self, grads):
        """The global squared norm of ``grads``: each parameter's squared
        norm summed over the axes that split it."""
        total = 0.0
        for split in sorted(set(self.split_axes)):
            part = sum(torch.sum(g * g) for g, s in
                       zip(grads, self.split_axes) if s == split)
            total = total + (self.mesh.all_reduce(part, split) if split
                             else part)
        return total

    def global_losses(self, losses):
        """The per-step losses of the global batch: every rank's share
        summed."""
        return self.mesh.all_reduce(losses, _AXES)
