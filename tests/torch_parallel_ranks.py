"""The ranks of the gloo world that ``tests/test_torch_parallel.py`` starts.

Each rank reads the cases (numpy inputs and plain parameters) from a
pickle, runs them through ``jrender_tpu_torch.parallel`` on the CPU and
writes its results to ``rank<r>.pkl`` beside it.  This module imports
neither JAX nor the JAX package: the test holds the results against JAX
in its own process.
"""
from __future__ import annotations

import os
import pickle
from types import SimpleNamespace

import torch
import torch.distributed as dist


def _raster(case, mesh):
    from jrender_tpu_torch.ops.softras import make_params
    from jrender_tpu_torch.parallel import soft_rasterize_sharded
    fv = torch.tensor(case['fv'], requires_grad=True)
    tex = torch.tensor(case['tex'], requires_grad=True)
    p = make_params(**case['params'])
    image = soft_rasterize_sharded(fv, tex, p, mesh, band_mode=case['mode'])
    (image * torch.tensor(case['g'])).sum().backward()
    return dict(image=image.detach().numpy(), gf=fv.grad.numpy(), gt=tex.grad.numpy())


def _nerf(case, mesh):
    from jrender_tpu_torch import convert
    from jrender_tpu_torch.nerf import trainer
    from jrender_tpu_torch.parallel import (make_sharded_nerf_step, nerf_param_specs,
                                            shard_nerf_params)
    args = SimpleNamespace(**case['args'])
    kwargs, _, _, nets, opt = trainer.create_nerf(args, device='cpu')
    nets.load_state_dict(convert.nerf_params_from_numpy(case['params'], 'cpu').state_dict())
    specs = nerf_param_specs(nets)
    shard_nerf_params(nets, mesh)
    step = make_sharded_nerf_step(opt, kwargs['network_query_fn'], mesh,
                                  N_samples=args.N_samples, N_importance=args.N_importance,
                                  white_bkgd=args.white_bkgd)
    rays, target = torch.tensor(case['rays']), torch.tensor(case['target'])
    losses = [float(step(nets, rays, target)) for _ in range(case['steps'])]
    return dict(specs=specs, losses=losses, params=convert.nerf_params_to_numpy(nets))


def _mesh_helpers(rank, mesh):
    from jrender_tpu_torch.parallel import replicate, shard_batch
    out = {'shard': shard_batch(torch.arange(8.0).reshape(8, 1), mesh).numpy(),
           'shard_axis1': shard_batch(torch.arange(12.0).reshape(3, 4), mesh, axis=1).numpy()}
    try:
        shard_batch(torch.zeros(3), mesh)
        out['shard_refuses'] = False
    except ValueError:
        out['shard_refuses'] = True
    tree = {'a': torch.full((3,), float(rank)), 'b': [torch.full((2,), 10.0 + rank)]}
    replicate(tree, mesh)
    out['replicated'] = [tree['a'].numpy(), tree['b'][0].numpy()]
    out['coords'] = (mesh.get_local_rank('data'), mesh.get_local_rank('model'))
    return out


def run_rank(rank: int, world: int, store: str, case_file: str) -> None:
    """One rank: join the world through the file store ``store``, run every
    case of ``case_file`` and write ``rank<rank>.pkl`` in its directory."""
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'file://{store}', rank=rank,
                            world_size=world)
    try:
        from jrender_tpu_torch.parallel import make_device_mesh
        with open(case_file, 'rb') as f:
            cases = pickle.load(f)
        # every rank makes the meshes in the same order (each makes groups)
        meshes = {n: make_device_mesh(n, world // n, device_type='cpu')
                  for n in sorted({c['n'] for c in cases['raster'].values()}
                                  | {cases['nerf']['n_data']})}
        out = {'raster': {name: _raster(c, meshes[c['n']])
                          for name, c in sorted(cases['raster'].items())},
               'mesh': _mesh_helpers(rank, meshes[cases['nerf']['n_data']]),
               'nerf': _nerf(cases['nerf'], meshes[cases['nerf']['n_data']])}
    finally:
        dist.destroy_process_group()
    path = os.path.join(os.path.dirname(case_file), f'rank{rank}.pkl')
    with open(path, 'wb') as f:
        pickle.dump(out, f)


def load_results(directory: str, world: int):
    """The ranks' results, in rank order."""
    out = []
    for r in range(world):
        with open(os.path.join(directory, f'rank{r}.pkl'), 'rb') as f:
            out.append(pickle.load(f))
    return out

