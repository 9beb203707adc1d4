"""The reference of nerf_tiny, for the harness's own test of a kind that
is not a mesh: the port's train step on the CPU, from the same weight seed
and draws.  A cell of the benchmark needs a plain reference of its own;
this one only shows that a kind, its reference and its check plug in."""
from __future__ import annotations

from types import SimpleNamespace

import torch


def fit(cfg: dict, inp, steps: int, dtype=torch.float32) -> dict:
    """The first ``steps`` steps from the program's start: each step's
    loss, the first step's gradients and the weights' change; with
    ``dtype`` bfloat16, the MLPs compute in it (``net_precision``)."""
    from jrender_tpu_torch.nerf import trainer
    args = SimpleNamespace(**dict(cfg['nerf'], net_precision='bf16' if dtype == torch.bfloat16
                                  else 'f32'))
    rk, _, _, nets, opt = trainer.create_nerf(
        args, generator=torch.Generator().manual_seed(inp.weight_seed), device='cpu')
    rk.pop('ndc', None)
    H = cfg['image_size']
    step = trainer.make_train_step(opt, rk, H, H, cfg['focal'], cfg['near'], cfg['far'],
                                   args.N_rand, 0, 0.5, False)
    params = list(nets.parameters())
    start = [p.detach().clone() for p in params]
    record = {'losses': []}
    for k in range(steps):
        p = k % inp.images.shape[0]
        loss, _ = step(nets, inp.images[p].cpu(), inp.poses[p].cpu(), k,
                       draws={n: v.cpu() for n, v in inp.step_draws(k).items()})
        record['losses'].append(float(loss))
        if k == 0:
            record['grads'] = [x.grad.detach().clone() for x in params]
    record['change'] = [x.detach() - s for x, s in zip(params, start)]
    return record
