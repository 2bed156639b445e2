"""Meshes over ``torch.distributed`` ranks: dp batch sharding,
member-parallel ensembles and hidden-dimension tensor parallelism (tp),
one process per rank (``launch``)."""
from .mesh import (Mesh, all_gather_grad, all_reduce_grad, batch_spec,
                   local_rows, make_mesh, pad_to_multiple, param_spec,
                   shard_leaf, shard_params)
from .multihost import initialize, is_multihost, process_info
from .launch import launch

__all__ = ['Mesh', 'make_mesh', 'batch_spec', 'param_spec', 'shard_leaf',
           'shard_params', 'pad_to_multiple', 'local_rows',
           'all_reduce_grad', 'all_gather_grad', 'initialize',
           'is_multihost', 'process_info', 'launch']
