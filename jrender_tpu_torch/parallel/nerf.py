"""Multi-rank NeRF training: rays data-parallel over the mesh's ``'data'`` axis.

Counterpart of ``jrender_tpu/parallel/nerf.py`` (``_param_spec`` :22,
``shard_nerf_params`` :32, ``make_sharded_nerf_step`` :44).  Each rank of
``'data'`` renders its share of the batch's rays through
``vol.ray_marching.render_rays``; the loss is the JAX package's global
mean (``img2mse`` of the whole batch, plus the coarse pass's); the
weights' gradients are all-reduced over the ``'data'`` group and the
optimizer steps on every rank alike.

The weights.  The JAX package's ``shard_nerf_params`` means to shard the
hidden weights' output features over ``'model'``: ``_param_spec`` gives
``P(None, 'model')`` to a leaf whose name ends in ``'w'``.  But it names a
leaf ``str(path[-1])``, which for a dict key is ``"['w']"``: the test never
matches, and every leaf of a NeRF tree is replicated (``P()``).  So the
JAX package's NeRF is rays data-parallel with the ``'model'`` ranks
holding copies, and so is the port's: ``nerf_param_specs`` keeps the rule
on the names as the JAX package forms them, and ``shard_nerf_params``
replicates the weights (it refuses a tree the rule would shard, which no
NeRF tree is).  The gradients are therefore all-reduced over ``'data'``
only: over the world they would count each copy again.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from ..nerf.model import NeRF, img2mse
from ..vol.ray_marching import render_rays
from .mesh import replicate, shard_batch


def _param_spec(path_leaf_shape):
    """Hidden weights shard their output-feature dim over 'model' (the JAX
    package's rule, on the JAX package's leaf names)."""
    name, shape = path_leaf_shape
    if name.endswith('w') and len(shape) == 2 and shape[1] % 2 == 0 and shape[1] >= 64:
        return (None, 'model')
    if name.endswith('b') and len(shape) == 1 and shape[0] % 2 == 0 and shape[0] >= 64:
        return ('model',)
    return ()


def _key_name(key) -> str:
    """A path entry as ``str`` prints the JAX package's: ``['w']`` for a
    dict key, ``[0]`` for a list index."""
    return f'[{key!r}]'


def _tree(nets_or_tree):
    """The weight tree of a ``NeRF``, a dict of them (an ``nn.ModuleDict``)
    or a tree of arrays, in the JAX package's layout."""
    if isinstance(nets_or_tree, NeRF):
        return nets_or_tree.tree()
    if isinstance(nets_or_tree, (dict, nn.ModuleDict)):
        return {k: _tree(v) for k, v in nets_or_tree.items()}
    if isinstance(nets_or_tree, (list, tuple)):
        return [_tree(v) for v in nets_or_tree]
    return nets_or_tree


def nerf_param_specs(nets_or_tree):
    """The placement the JAX package's ``shard_nerf_params`` gives each leaf
    of the weight tree, as the tree of its ``PartitionSpec``'s entries:
    ``()`` replicated, ``(None, 'model')`` / ``('model',)`` sharded over
    ``'model'``."""
    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, i) for i, v in enumerate(node)]
        return _param_spec((_key_name(key), tuple(node.shape)))
    return walk(_tree(nets_or_tree), None)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def shard_nerf_params(nets_or_tree, mesh: DeviceMesh):
    """Place the NeRF weights on ``mesh`` as the JAX package's
    ``shard_nerf_params`` does (``nerf_param_specs``): every leaf of a
    NeRF tree replicated, broadcast from the mesh's first rank in place.
    Returns ``nets_or_tree``."""
    sharded = [s for s in _leaves(nerf_param_specs(nets_or_tree)) if s]
    if sharded:
        raise NotImplementedError(f'{len(sharded)} weights would be sharded over '
                                  f"'model'; the port replicates NeRF weights only")
    return replicate(nets_or_tree, mesh)


def make_sharded_nerf_step(optimizer, network_query_fn, mesh: DeviceMesh, N_samples=32,
                           N_importance=0, white_bkgd=False):
    """A train step with rays sharded over ``'data'``.

    ``step(nets, ray_batch, target, draws=None)``: ``nets`` a dict of
    ``NeRF`` (``'coarse'``, and ``'fine'`` where ``N_importance`` > 0),
    the same on every rank; ``ray_batch`` [N, 8 or 11] and ``target``
    [N, 3] the whole batch, the same on every rank; ``draws`` the render's
    draws for the whole batch (``vol.ray_marching``), none with the
    default ``perturb = 0``.  The rank renders its share of the rays, the
    gradient of the global mean loss is all-reduced over ``'data'``, and
    ``optimizer`` (``zero_grad``, ``step``) updates ``nets``.  Returns the
    global loss."""
    group = mesh.get_group('data')
    n = mesh.size(0)

    def step(nets, ray_batch, target, draws=None):
        rays = shard_batch(ray_batch, mesh)
        tgt = shard_batch(target, mesh)
        draws = {k: shard_batch(v, mesh) for k, v in (draws or {}).items()}
        out = render_rays(rays, nets['coarse'], network_query_fn, N_samples,
                          N_importance=N_importance,
                          network_fine=nets['fine'] if 'fine' in nets else None,
                          white_bkgd=white_bkgd, draws=draws)
        loss = img2mse(out['rgb_map'], tgt)
        if 'rgb0' in out:
            loss = loss + img2mse(out['rgb0'], tgt)
        optimizer.zero_grad()
        loss.backward()
        # the share's mean over n equal shares is the batch's mean: sum the
        # shares' gradients and losses over 'data', divide by n
        params = [q for q in nets.parameters() if q.grad is not None]
        flat = torch.cat([q.grad.reshape(-1) for q in params]
                         + [loss.detach().reshape(1)])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat = flat / n
        off = 0
        for q in params:
            q.grad.copy_(flat[off:off + q.numel()].reshape(q.shape))
            off += q.numel()
        optimizer.step()
        return flat[-1]

    return step
