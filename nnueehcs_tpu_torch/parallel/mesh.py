"""Named device meshes over the ranks of a ``torch.distributed`` group.

Counterpart of ``nnueehcs_tpu/parallel/mesh.py``. The JAX package is one
controller over every device: XLA's SPMD partitioner inserts the
collectives a sharding needs. The port runs one process per rank (NCCL
for ranks that each own a card, gloo for CPU ranks, or gloo on CUDA
tensors when the caller names it), and the code that shards a
computation calls the collectives itself, through the methods of
:class:`Mesh`.

A :class:`Mesh` is a small class, not ``torch.distributed.device_mesh``:
it holds the axis sizes, this rank's coordinate on each axis, its device
and one process group per axis (the ranks that share every other
coordinate), made once when the mesh is made. Ranks are laid out
row-major over the axes in their order, as JAX reshapes its device list.
Axes:

- ``dp``: batch rows (evaluation buckets, training batches, a KDE
  corpus) split over its ranks;
- ``member``: the stacked member axis of an ensemble split over its ranks;
- ``tp``: the output features of each Linear whose width divides, split
  over its ranks (training only).

A mesh of size 1 needs no process group: every collective is the
identity, and a process that never initialised ``torch.distributed`` can
make one (``{'dp': 1}``, or ``'auto'`` there).

torch.distributed's backend table lists only ``all_reduce`` and
``broadcast`` for gloo on CUDA tensors, but gloo in torch 2.11 (the card's)
also takes the all-gathers, ``reduce_scatter_tensor`` and ``barrier`` on
them (``chip_smoke.py``'s ``parallel`` phase probes each), so the mesh
passes CUDA tensors to every collective under either backend; gloo copies
them through host memory itself.
"""
from __future__ import annotations

import math
from datetime import timedelta
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

AXES = ('dp', 'member', 'tp')
#: every group's timeout: a rank that stops fails the others, not hangs them
DEFAULT_TIMEOUT = timedelta(seconds=120)


def _world() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) when
    ``torch.distributed`` is not initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _default_device(backend, rank):
    """A rank's device when the mesh is made without ``devices``: its card
    under NCCL; None (the caller's) under gloo, whose ranks may sit on the
    CPU or on a card."""
    if backend == 'nccl':
        return torch.device('cuda', rank % max(torch.cuda.device_count(), 1))
    return None


class Mesh:
    """Named axes over ranks (see the module docstring). ``shape`` maps an
    axis to its size, ``axis_names`` keeps their order, ``rank`` is this
    process's index in the mesh (None when the mesh leaves it out),
    ``device`` its device (None when the mesh was made without devices
    under gloo or without a process group: the caller's; see
    :func:`placed`)."""

    def __init__(self, axes: Dict[str, int], rank: Optional[int], device,
                 groups: Dict[str, object], backend: Optional[str]):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)
        self.size = math.prod(self.shape.values())
        self.rank = rank
        self.device = None if device is None else torch.device(device)
        self.backend = backend
        self._groups = groups
        self.coords = {}
        if rank is not None:
            idx = np.unravel_index(rank, tuple(self.shape.values())) \
                if self.shape else ()
            self.coords = {a: int(i) for a, i in zip(self.axis_names, idx)}

    def __repr__(self):
        return f'Mesh({self.shape}, rank={self.rank}, device={self.device})'

    def axis_size(self, axis: str) -> int:
        """The size of ``axis``; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``; 0 for an absent axis."""
        self._require_member()
        return self.coords.get(axis, 0)

    @property
    def is_trivial(self) -> bool:
        """True when every axis has size 1: one device, no collective."""
        return self.size == 1

    def _require_member(self):
        if self.rank is None:
            raise ValueError(f'this process is not one of the {self.size} '
                             f'ranks of {self.shape}')

    def _axes(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in axes if self.axis_size(a) > 1)

    # ------------------------------------------------------------ collectives
    def all_reduce(self, t: torch.Tensor, axes, op: str = 'sum'):
        """``t`` reduced (``'sum'`` or ``'max'``) over the ranks of each of
        ``axes`` in turn; a new tensor. Not differentiable: see
        :func:`all_reduce_grad`."""
        self._require_member()
        out = t.clone()
        red = dist.ReduceOp.SUM if op == 'sum' else dist.ReduceOp.MAX
        for a in self._axes(axes):
            dist.all_reduce(out, op=red, group=self._groups[a])
        return out

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0):
        """The ``t`` of every rank of ``axis``, in coordinate order,
        concatenated along ``dim`` (every rank's ``t`` has one shape). Not
        differentiable: see :func:`all_gather_grad`."""
        self._require_member()
        n = self.axis_size(axis)
        if n == 1:
            return t
        src = t.contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=self._groups[axis])
        return torch.cat(parts, dim=dim)

    def broadcast_object(self, obj, src: int = 0):
        """``obj`` of mesh rank ``src`` on every rank of the mesh (a
        picklable object; the others pass anything)."""
        self._require_member()
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self._groups[None],
                                   device=self.device
                                   if self.backend == 'nccl' else None)
        return box[0]

    def barrier(self):
        self._require_member()
        if self.size > 1:
            dist.barrier(group=self._groups[None])


class _AllReduceSum(torch.autograd.Function):
    """A sum over ranks whose gradient is the sum of every rank's
    gradient (``torch.distributed.nn.functional.all_reduce``, through the
    mesh's groups)."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh.all_reduce(t, axes)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad.contiguous(), ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    """The ranks' tensors concatenated along ``dim``; the gradient of a
    rank's part is the sum over ranks of their gradients of that part."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.width = t.shape[dim]
        return mesh.all_gather(t, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        total = ctx.mesh.all_reduce(grad.contiguous(), ctx.axis)
        i = ctx.mesh.axis_index(ctx.axis)
        return total.narrow(ctx.dim, i * ctx.width, ctx.width), None, None, None


def all_reduce_grad(t, mesh: Optional[Mesh], axes):
    """Differentiable sum of ``t`` over ``axes`` (identity without a mesh
    or on axes of size 1)."""
    if mesh is None or not mesh._axes(axes):
        return t
    return _AllReduceSum.apply(t, mesh, axes)


def all_gather_grad(t, mesh: Optional[Mesh], axis: str, dim: int = 0):
    """Differentiable all-gather of ``t`` over ``axis`` along ``dim``."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return t
    return _AllGather.apply(t, mesh, axis, dim)


def _normalise_axes(axes, world: int) -> Dict[str, int]:
    if not axes or axes == 'auto':
        return {'dp': world}
    if not isinstance(axes, dict):
        raise TypeError(f"mesh axes must be a dict or 'auto', got {axes!r}")
    out = {}
    for name, size in axes.items():
        if name not in AXES:
            raise ValueError(f'unknown mesh axis {name!r}; the axes are '
                             f'{AXES}')
        if int(size) < 1:
            raise ValueError(f'mesh axis {name!r} has size {size}')
        out[name] = int(size)
    return out


def as_device(d) -> torch.device:
    """A device name, ``torch.device`` or card index as a ``torch.device``."""
    return torch.device('cuda', d) if isinstance(d, int) else torch.device(d)


def check_nccl_devices(devices):
    """Refuse NCCL ranks that would share a card: NCCL takes one rank a
    GPU and fails on a duplicate, and the port does not switch to gloo on
    its own."""
    used = [as_device(d) for d in devices]
    if len(set(used)) < len(used):
        raise ValueError(
            f'NCCL puts one rank on each card; {len(used)} ranks would share '
            f'{sorted(set(map(str, used)))} (duplicate GPU). Use one rank a '
            "card, or name backend='gloo'")


def make_mesh(axes=None, devices: Optional[Sequence] = None,
              timeout: timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """A mesh from an ``{axis: size}`` dict, e.g. ``{'dp': 4, 'member':
    2}``, over the ranks of the default process group (this process alone
    when ``torch.distributed`` is not initialised). ``None`` or ``'auto'``
    puts every rank on ``dp``. ``devices`` gives each rank's device in rank
    order (default: ``cuda:<rank>`` under NCCL; none under gloo, where
    each entry point keeps its caller's device).

    Every rank of the group must call it with the same arguments, in the
    same order as any other mesh it makes (it makes process groups). It
    raises ``ValueError`` when the mesh needs more ranks than there are,
    or more than ``devices`` names, and when NCCL would put two ranks on
    one card (NCCL refuses a duplicate GPU; the port does not switch to
    gloo on its own). ``timeout`` bounds each of its groups' collectives:
    a rank that stops fails the others instead of hanging them."""
    rank, world = _world()
    shape = _normalise_axes(axes, world)
    total = math.prod(shape.values())
    if total > world:
        raise ValueError(f'Mesh {shape} needs {total} ranks, have {world}')
    if devices is not None:
        devices = [as_device(d) for d in devices]
        if total > len(devices):
            raise ValueError(f'Mesh {shape} needs {total} devices, have '
                             f'{len(devices)}')
    backend = dist.get_backend() if world > 1 or dist.is_initialized() \
        else None
    if backend == 'nccl':
        check_nccl_devices(devices[:total] if devices is not None else [
            _default_device('nccl', r) for r in range(total)])
    groups = {}
    if total > 1:
        grid = np.arange(total).reshape(tuple(shape.values()))
        groups[None] = dist.new_group(list(range(total)), timeout=timeout)
        for i, axis in enumerate(shape):
            moved = np.moveaxis(grid, i, -1).reshape(-1, shape[axis])
            for ranks in moved:
                g = dist.new_group([int(r) for r in ranks], timeout=timeout)
                if rank in ranks:
                    groups[axis] = g
    in_mesh = rank < total
    device = None
    if in_mesh:
        device = devices[rank] if devices is not None \
            else _default_device(backend, rank)
    return Mesh(shape, rank if in_mesh else None, device, groups, backend)


def placed(mesh: Optional[Mesh], device) -> Optional[torch.device]:
    """The device of this rank's work: the mesh's device when it names
    one, else ``device``. Raises ``ValueError`` when ``device`` names
    another one (another type, or another card's index; ``'cuda'`` without
    an index takes the mesh's card): an entry point never moves work off
    the device its caller asked for, a card's work to the CPU least of
    all."""
    want = None if device is None else as_device(device)
    if mesh is None or mesh.device is None:
        return want
    have = mesh.device
    if want is not None and (want.type != have.type or (
            None not in (want.index, have.index)
            and want.index != have.index)):
        raise ValueError(f'the mesh puts rank {mesh.rank} on {have}, but '
                         f'{want} was asked for: give the mesh the same '
                         'device (make_mesh(devices=...)) or ask for its '
                         'device')
    return have


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis sizes of a :class:`Mesh` or of an ``{axis: size}`` dict."""
    return dict(mesh.shape) if isinstance(mesh, Mesh) else dict(mesh)


def batch_spec(mesh) -> tuple:
    """Rows over ``dp`` when the mesh has it, else replicated: ``('dp',)``
    or ``()``, as JAX's ``P('dp')`` and ``P()``."""
    return ('dp',) if 'dp' in mesh_sizes(mesh) else ()


def param_spec(leaf, mesh, member_stacked: bool = False) -> tuple:
    """One axis name or None for each dimension of a parameter or state
    leaf in the JAX package's layout (``mesh`` a :class:`Mesh` or an
    ``{axis: size}`` dict), by the JAX package's rules:

    - the stacked member axis (the first) over ``member`` (ensembles);
    - the last (output-feature) axis of a leaf of two or more dimensions
      over ``tp`` when the mesh has it and the width divides evenly;
    - everything else replicated.
    """
    sizes = mesh_sizes(mesh)
    ndim = len(leaf.shape)
    if ndim == 0:
        return ()
    spec = [None] * ndim
    if member_stacked and 'member' in sizes:
        spec[0] = 'member'
    feat_dims = ndim - (1 if member_stacked else 0)
    if 'tp' in sizes and feat_dims >= 1 and ndim >= 2 \
            and leaf.shape[-1] % sizes['tp'] == 0:
        spec[-1] = 'tp'
    return tuple(spec)


def _block(n: int, parts: int, index: int) -> slice:
    width = n // parts
    return slice(index * width, (index + 1) * width)


def shard_leaf(leaf, spec: tuple, mesh: Mesh):
    """This rank's block of a full ``leaf`` under ``spec``; an axis that
    shards a dimension its size does not divide raises ``ValueError``."""
    out = leaf
    for dim, axis in enumerate(spec):
        if axis is None or mesh.axis_size(axis) == 1:
            continue
        n, parts = leaf.shape[dim], mesh.axis_size(axis)
        if n % parts:
            raise ValueError(f'dimension {dim} of size {n} does not divide '
                             f'over mesh axis {axis!r} of size {parts}')
        index = [slice(None)] * len(leaf.shape)
        index[dim] = _block(n, parts, mesh.axis_index(axis))
        out = out[tuple(index)]
    return out


def shard_params(params, mesh: Mesh, member_stacked: bool = False):
    """This rank's slices of a parameter pytree (tuples, lists and dicts of
    arrays or tensors in the JAX package's layout) under
    :func:`param_spec`."""
    if isinstance(params, dict):
        return {k: shard_params(v, mesh, member_stacked)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(shard_params(v, mesh, member_stacked)
                            for v in params)
    return shard_leaf(params, param_spec(params, mesh, member_stacked), mesh)


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Pad ``x`` along ``axis`` with copies of its last row until the
    length divides by ``multiple`` (JAX's ``mode='edge'``); returns
    ``(padded, n_valid)``."""
    n = x.shape[axis]
    rem = n % multiple
    if rem == 0:
        return x, n
    last = x.narrow(axis, n - 1, 1) if isinstance(x, torch.Tensor) \
        else np.take(x, [n - 1], axis=axis)
    reps = [1] * x.ndim
    reps[axis] = multiple - rem
    if isinstance(x, torch.Tensor):
        return torch.cat([x, last.repeat(*reps)], dim=axis), n
    return np.concatenate([x, np.tile(last, reps)], axis=axis), n


def local_rows(n: int, mesh) -> tuple[int, int]:
    """``(lo, hi)``: this rank's contiguous rows of ``n`` split over
    ``dp`` (the first ``n % dp`` ranks take one row more; all of them
    without a ``dp`` axis)."""
    if mesh is None or mesh.axis_size('dp') == 1:
        return 0, n
    dp, r = mesh.axis_size('dp'), mesh.axis_index('dp')
    base, extra = divmod(n, dp)
    lo = r * base + min(r, extra)
    return lo, lo + base + (1 if r < extra else 0)
