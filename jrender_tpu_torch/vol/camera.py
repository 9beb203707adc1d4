"""Pinhole camera rays and the NDC warp (plain PyTorch).

Counterpart of ``jrender_tpu/vol/camera.py``.  The volume stack's rays
(``pinhole_get_rays``) negate x and y; ``get_rays`` (the nerf_helper
convention) does not.  Every function works on its inputs' device: the
camera matrix's for the ray generators.
"""
from __future__ import annotations

import torch


def linspace0(stop, num, device=None):
    """``jnp.linspace(0, stop, num)`` in float32 with the JAX package's bits:
    XLA folds it on the CPU into ``i * (stop * (1 / (num - 1)))``, the last
    value ``stop`` itself (``torch.linspace`` rounds otherwise)."""
    if num == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    one = torch.tensor(1.0, dtype=torch.float32)
    scale = torch.tensor(float(stop), dtype=torch.float32) * (one / float(num - 1))
    out = torch.arange(num, dtype=torch.float32) * scale
    out[-1] = float(stop)
    return out.to(device)


def _sum3(v):
    """Sum of the last dim (3 terms), added left to right."""
    return v[..., 0] + v[..., 1] + v[..., 2]


def _get_rays(H, W, focal, c2w, intrinsic, sign):
    c2w = torch.as_tensor(c2w, dtype=torch.float32)
    i = linspace0(W - 1, W, c2w.device)[None, :].expand(H, W)
    j = linspace0(H - 1, H, c2w.device)[:, None].expand(H, W)
    if intrinsic is None:
        dirs = torch.stack([sign * (i - W * 0.5) / focal, sign * (j - H * 0.5) / focal,
                            torch.ones_like(i)], -1)
    else:
        intrinsic = torch.as_tensor(intrinsic, dtype=torch.float32, device=c2w.device)
        dirs = torch.stack([i + 0.5, j + 0.5, torch.ones_like(i)], -1)
        dirs = _sum3(dirs[..., None, :] * intrinsic[:3, :3])
    rays_d = _sum3(dirs[..., None, :] * c2w[:3, :3])
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def pinhole_get_rays(H: int, W: int, focal, c2w, intrinsic=None):
    """Rays for a full image; returns (rays_o [H,W,3], rays_d [H,W,3])."""
    return _get_rays(H, W, focal, c2w, intrinsic, -1.0)


def get_rays(H: int, W: int, focal, c2w, intrinsic=None):
    """nerf_helper-convention rays (positive x and y)."""
    return _get_rays(H, W, focal, c2w, intrinsic, 1.0)


def ndc_rays(H, W, focal, near, rays_o, rays_d):
    """Warp rays into NDC space for forward-facing (LLFF) scenes."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2] -
                                       rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (H / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2] -
                                       rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]

    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)
