"""Hierarchical volumetric ray marching (plain PyTorch).

Counterpart of ``jrender_tpu/vol/ray_marching.py``.  The JAX package
splits one key four ways; here each of the four draws comes in ``draws``
(``t_rand`` [N, N_samples] for the strata, ``noise`` [N, N_samples] for the
coarse density, ``u`` [N, N_importance] for the importance samples,
``noise2`` [N, N_samples + N_importance] for the fine density) or is drawn
from ``generator``.
"""
from __future__ import annotations

import torch

from .integrator import integrator, sample, sample_pdf


def render_rays(ray_batch, network_fn, network_query_fn, N_samples,
                retraw=False, lindisp=False, perturb=0.0, N_importance=0,
                network_fine=None, white_bkgd=False, raw_noise_std=0.0,
                draws=None, generator=None, embed_depth=False, **kwargs):
    """ray_batch: [N, 8(+3)] rows = [o, d, near, far, (viewdirs)]."""
    draws = draws or {}
    N_rays = ray_batch.shape[0]
    rays_o, rays_d = ray_batch[:, 0:3], ray_batch[:, 3:6]
    viewdirs = ray_batch[:, -3:] if ray_batch.shape[-1] > 8 else None
    bounds = ray_batch[..., 6:8].reshape(-1, 1, 2)
    near, far = bounds[..., 0], bounds[..., 1]

    z_vals = sample(N_rays, N_samples, lindisp, perturb, near, far,
                    draws.get('t_rand'), generator)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    if embed_depth:
        pts = torch.cat([pts, z_vals[..., None]], -1)

    raw = network_query_fn(pts, viewdirs, network_fn)
    rgb_map, disp_map, acc_map, weights, depth_map = integrator(
        raw, z_vals, rays_d, raw_noise_std, white_bkgd, draws.get('noise'), generator)

    rgb_map_0, disp_map_0, acc_map_0 = rgb_map, disp_map, acc_map
    if N_importance > 0:
        with torch.no_grad():      # the samples carry no gradient
            z_vals_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
            z_samples = sample_pdf(z_vals_mid, weights[..., 1:-1].detach(), N_importance,
                                   det=(perturb == 0.0), u=draws.get('u'),
                                   generator=generator)

        z_vals, _ = torch.sort(torch.cat([z_vals, z_samples], -1), -1)
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
        if embed_depth:
            pts = torch.cat([pts, z_vals[..., None]], -1)

        run_fn = network_fn if network_fine is None else network_fine
        raw = network_query_fn(pts, viewdirs, run_fn)
        rgb_map, disp_map, acc_map, weights, depth_map = integrator(
            raw, z_vals, rays_d, raw_noise_std, white_bkgd, draws.get('noise2'), generator)

    ret = {'rgb_map': rgb_map, 'disp_map': disp_map, 'acc_map': acc_map}
    if retraw:
        ret['raw'] = raw
    if N_importance > 0:
        ret['rgb0'] = rgb_map_0
        ret['disp0'] = disp_map_0
        ret['acc0'] = acc_map_0
    return ret
