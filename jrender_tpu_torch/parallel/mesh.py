"""Device meshes over torch.distributed (counterpart of ``jrender_tpu/parallel/mesh.py``).

The workload's parallel axes, as in the JAX package:
  * ``'data'``: rays (NeRF) or pixel bands (the rasterizer).  The
    rasterizer's forward is parallel over pixels (the softmax aggregation
    is pixel-local); gradients are summed over ``'data'`` by all-reduces.
  * ``'model'``: replicas.  The JAX package names it for tensor-parallel
    NeRF weights, but its rule shards no weight (``nerf.py``), so the
    ranks of one ``'data'`` coordinate hold copies.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` of shape
(n_data, n_model) over ranks 0 .. n_data * n_model - 1 of the default
process group, dim names ``('data', 'model')``.  Every rank of the world
calls ``make_device_mesh`` (it makes one process group per row and
column of the mesh).  The caller starts the world
(``torch.distributed.init_process_group``: NCCL on cards, gloo on the CPU).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

AXES = ('data', 'model')


def make_device_mesh(n_data: int | None = None, n_model: int = 1,
                     device_type: str = 'cuda') -> DeviceMesh:
    """A (n_data, n_model) mesh over the world's first n_data * n_model
    ranks; ``n_data`` defaults to the world size over ``n_model``.  The
    CPU tests pass ``device_type='cpu'``."""
    n = dist.get_world_size()
    if n_data is None:
        n_data = n // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > n:
        raise ValueError(f'a {n_data} x {n_model} mesh does not fit a world of {n} ranks')
    ranks = torch.arange(n_data * n_model).reshape(n_data, n_model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


def shard_batch(x: torch.Tensor, mesh: DeviceMesh, axis: int = 0) -> torch.Tensor:
    """This rank's share of ``x`` along ``axis``: the ``'data'`` coordinate's
    slice of equal shares.  Raises where the size does not divide (as the
    JAX package's ``device_put`` does)."""
    n = mesh.size(0)
    size = x.shape[axis]
    if size % n:
        raise ValueError(f'{size} rows along axis {axis} do not divide over {n} data ranks')
    per = size // n
    return x.narrow(axis, mesh.get_local_rank('data') * per, per)


def _tensors(tree):
    """The tensors of a tree of dicts, lists, tuples and modules, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, nn.Module):
        return [*tree.parameters(), *tree.buffers()]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def replicate(tree, mesh: DeviceMesh):
    """Broadcast every tensor of ``tree`` (tensors, dicts, lists, tuples,
    modules' parameters and buffers) from the mesh's first rank, in place,
    and return ``tree``: first along ``'data'`` (each ``'model'`` column
    from its first row), then along ``'model'`` (each row from its first
    column, which then holds the first rank's values)."""
    with torch.no_grad():
        for axis in AXES:
            group = mesh.get_group(axis)
            src = dist.get_global_rank(group, 0)
            for t in _tensors(tree):
                dist.broadcast(t.data, src=src, group=group)
    return tree
