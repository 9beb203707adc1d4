"""The volume render pass (plain PyTorch).

Counterpart of ``jrender_tpu/vol/render_pass.py``.  Rays are rendered in
chunks of ``chunk`` rows by a Python loop over slices (the JAX package
pads them into one ``lax.map``); ``draws`` (see ``ray_marching``) are
given for all rays and sliced with them.
"""
from __future__ import annotations

import torch

from .camera import ndc_rays, pinhole_get_rays
from .integrator import ray_norm
from .ray_marching import render_rays


def batchify_rays(rays_flat, chunk=1024 * 32, draws=None, generator=None, **kwargs):
    """Render rays in chunks of ``chunk`` rows; returns a dict of [N, ...]."""
    N = rays_flat.shape[0]
    if N <= chunk:
        return render_rays(rays_flat, draws=draws, generator=generator, **kwargs)
    outs = []
    for i in range(0, N, chunk):
        d = None if draws is None else {k: v[i:i + chunk] for k, v in draws.items()}
        outs.append(render_rays(rays_flat[i:i + chunk], draws=d, generator=generator, **kwargs))
    return {k: torch.cat([o[k] for o in outs], 0) for k in outs[0]}


def render(H, W, focal, chunk=1024 * 32, rays=None, c2w=None, intrinsic=None,
           ndc=True, near=0.0, far=1.0, use_viewdirs=False, c2w_staticcam=None,
           draws=None, generator=None, **kwargs):
    """Render rays (``rays`` = (rays_o, rays_d)) or a full image (``c2w``).

    Returns [rgb_map, disp_map, acc_map, extras_dict]."""
    if c2w is not None:
        rays_o, rays_d = pinhole_get_rays(H, W, focal, c2w, intrinsic)
    else:
        rays_o, rays_d = rays

    if use_viewdirs:
        viewdirs = rays_d
        if c2w_staticcam is not None:
            assert intrinsic is None
            rays_o, rays_d = pinhole_get_rays(H, W, focal, c2w_staticcam)
        viewdirs = viewdirs / ray_norm(viewdirs)[..., None]
        viewdirs = viewdirs.reshape(-1, 3).float()

    sh = rays_d.shape
    if ndc:
        rays_o, rays_d = ndc_rays(H, W, focal, 1.0, rays_o, rays_d)

    rays_o = rays_o.reshape(-1, 3).float()
    rays_d = rays_d.reshape(-1, 3).float()

    near_v = near * torch.ones_like(rays_d[..., :1])
    far_v = far * torch.ones_like(rays_d[..., :1])
    rays_cat = torch.cat([rays_o, rays_d, near_v, far_v], -1)
    if use_viewdirs:
        rays_cat = torch.cat([rays_cat, viewdirs], -1)

    all_ret = batchify_rays(rays_cat, chunk, draws=draws, generator=generator, **kwargs)
    all_ret = {k: v.reshape(tuple(sh[:-1]) + tuple(v.shape[1:])) for k, v in all_ret.items()}

    k_extract = ['rgb_map', 'disp_map', 'acc_map']
    ret_list = [all_ret[k] for k in k_extract]
    ret_dict = {k: all_ret[k] for k in all_ret if k not in k_extract}
    return ret_list + [ret_dict]
