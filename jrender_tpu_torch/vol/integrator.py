"""Stratified and importance sampling and alpha compositing (plain PyTorch).

Counterpart of ``jrender_tpu/vol/integrator.py``.  Draws come in as
tensors (``t_rand`` for ``sample``, ``u`` for ``sample_pdf``, ``noise``,
the standard normal draw, for ``integrator``) or from ``generator``, a
``torch.Generator`` on the inputs' device; with neither the functions are
deterministic, as the JAX package's are with ``key=None``.

Orders of summation.  On the CPU the JAX package adds a row of up to 64
terms in XLA's order (``row_sum``) and takes its cumulative sums and
products in blocks of 16 (``ops.image.prefix_sum`` / ``prefix_prod``); the
PDF's normaliser, its CDF and the transmittance follow those orders, so a
draw ``u`` falls in the same CDF bin in both packages.  The maps' sums over
samples use ``torch.sum``.
"""
from __future__ import annotations

import torch

from ..ops.image import prefix_prod, prefix_sum
from .camera import linspace0


def _seq_sum(x):
    out = x[..., 0]
    for k in range(1, x.shape[-1]):
        out = out + x[..., k]
    return out


def row_sum(x):
    """Sum of the last dim in the order of XLA's CPU reduction: up to 32
    terms left to right; up to 64 in two halves of ceil(n / 2); more in
    blocks of 32, whose totals are reduced the same way (the JAX package's
    bits where n <= 64 or n % 32 is 0 or 31)."""
    n = x.shape[-1]
    if n <= 32:
        return _seq_sum(x)
    k = -(-n // 2) if n <= 64 else 32
    m = -(-n // k)
    xp = torch.nn.functional.pad(x, (0, m * k - n))
    return row_sum(_seq_sum(xp.reshape(*x.shape[:-1], m, k)))


def sample(N_rays, N_samples, lindisp, perturb, near, far, t_rand=None, generator=None):
    """Stratified z values [N_rays, N_samples]; ``near`` and ``far`` are
    tensors of shape [N_rays, 1] (or broadcast to it)."""
    near = torch.as_tensor(near, dtype=torch.float32)
    far = torch.as_tensor(far, dtype=torch.float32, device=near.device)
    t_vals = linspace0(1.0, N_samples, near.device)
    if not lindisp:
        z_vals = near * (1.0 - t_vals) + far * t_vals
    else:
        z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    z_vals = z_vals.expand(N_rays, N_samples)

    if perturb > 0.0 and (t_rand is not None or generator is not None):
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], -1)
        lower = torch.cat([z_vals[..., :1], mids], -1)
        if t_rand is None:
            t_rand = torch.rand(z_vals.shape, generator=generator, device=z_vals.device)
        z_vals = lower + (upper - lower) * t_rand
    return z_vals


def sample_pdf(bins, weights, N_samples, det=False, u=None, generator=None):
    """Inverse-CDF importance sampling: ``N_samples`` z values a ray from the
    piecewise-constant PDF of ``weights`` over ``bins``."""
    weights = weights + 1e-5
    pdf = weights / row_sum(weights)[..., None]
    cdf = prefix_sum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)

    shape = cdf.shape[:-1] + (N_samples,)
    if det or (u is None and generator is None):
        u = linspace0(1.0, N_samples, cdf.device).expand(shape)
    elif u is None:
        u = torch.rand(shape, generator=generator, device=cdf.device)
    u = u.contiguous()

    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (inds - 1).clamp_min(0)
    above = inds.clamp_max(cdf.shape[-1] - 1)

    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bins_b = torch.gather(bins, -1, below.clamp_max(bins.shape[-1] - 1))
    bins_a = torch.gather(bins, -1, above.clamp_max(bins.shape[-1] - 1))

    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)


def ray_norm(rays_d):
    """|rays_d| over the last dim, its squares added left to right."""
    return torch.sqrt(rays_d[..., 0] * rays_d[..., 0] + rays_d[..., 1] * rays_d[..., 1]
                      + rays_d[..., 2] * rays_d[..., 2])


def integrator(raw, z_vals, rays_d, raw_noise_std=0.0, white_bkgd=False, noise=None,
               generator=None):
    """Alpha-composite raw (rgb, sigma) predictions along rays.

    raw: [N_rays, N_samples, 4].  Returns (rgb_map, disp_map, acc_map,
    weights, depth_map)."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
    dists = dists * ray_norm(rays_d)[..., None]

    rgb = torch.sigmoid(raw[..., :3])
    sigma = raw[..., 3]
    if raw_noise_std > 0.0 and (noise is not None or generator is not None):
        if noise is None:
            noise = torch.randn(sigma.shape, generator=generator, device=sigma.device)
        sigma = sigma + noise * raw_noise_std
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    trans = prefix_prod(torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], -1),
                        -1)[..., :-1]
    weights = alpha * trans
    rgb_map = torch.sum(weights[..., None] * rgb, -2)

    depth_map = torch.sum(weights * z_vals, -1)
    acc_map = torch.sum(weights, -1)
    disp_map = 1.0 / torch.clamp_min(depth_map / torch.clamp_min(acc_map, 1e-10), 1e-10)

    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return rgb_map, disp_map, acc_map, weights, depth_map
