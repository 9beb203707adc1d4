"""Screen-space image ops of the deferred pipeline and of SSS (plain PyTorch).

Counterpart of ``jrender_tpu/ops/image.py``; the reference kernels are
  * sample2D            -- jrender/Scene/textures/utils/sample2D.py:4-100
  * conv_for_image      -- jrender/render2/utils/cuda/conv.py:5-21
  * gaussian_blur (SSS) -- jrender/renderer/utils/gaussian_blur.py:29-
  * compute_stretch_map -- jrender/renderer/utils/ToStretchMap.py:5-13
  * generate_SAT        -- Scene/textures/texture.py:115-139 (f32 cumsum)
  * VSSM                -- render2/utils/cuda/VSSM_cuda.py:23-118
  * SSAO / SSDO         -- SSAO_cuda.py:109-171 / SSDO_cuda.py
  * SSR                 -- SSR_cuda.py:7-262 (naive2 DDA march)
  * SSR_hiz             -- SSR_cuda.py:260-540 (Hi-Z march)
  * SSSR                -- SSSR_cuda.py (GGX importance-sampled march)
  * FXAA                -- FXAA_cuda.py:3-260

Every op works on whole images on their device.  A march is a Python loop
of vectorised steps over every pixel: ``max_steps`` bounds it, and a ray
unfinished at the bound is a miss, as in the JAX package.  The loop stops
early once every ray is done, which changes no output: a done ray's state
no longer moves.

Random draws.  ``SSAO``, ``SSDO`` and ``SSSR`` take ``samples``, the
uniform draws in the JAX package's shapes (``(sample_num, 3)``; SSSR
``(spp, 2, H, W)``), or draw them from ``generator`` (a ``torch.Generator``
on the image's device; None: one seeded 0).  The port's draws are not the
JAX package's ``PRNGKey(0)`` draws; pass those as ``samples`` to compute on
the same numbers.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as Fn

from ..utils.math import normalize

DONE_CHECK = 16          # march steps between the checks that every ray is done


def _generator(device, generator):
    if generator is not None:
        return generator
    g = torch.Generator(device=device)
    g.manual_seed(0)
    return g


def _uniform(shape, device, samples, generator):
    if samples is not None:
        if not isinstance(samples, torch.Tensor):
            samples = torch.from_numpy(np.array(samples, np.float32))
        s = samples.to(device=device, dtype=torch.float32)
        if tuple(s.shape) != tuple(shape):
            raise ValueError(f'samples of shape {tuple(s.shape)}, expected {tuple(shape)}')
        return s
    return torch.rand(shape, generator=_generator(device, generator), device=device)


def _pixel_ndc(is_, device):
    """(ys, xs, xi, yi): pixel rows and columns and their NDC centres."""
    ys, xs = torch.meshgrid(torch.arange(is_, device=device),
                            torch.arange(is_, device=device), indexing='ij')
    xi = (2 * xs.float() + 1 - is_) / is_
    yi = (2 * (is_ - 1 - ys.float()) + 1 - is_) / is_
    return ys, xs, xi, yi


# -- sampling / convolution -------------------------------------------------

def sample2D(texture, pos, default=999999.0):
    """Bilinear sample of texture [H,W(,C)] at uv pos [...,2] in [0,1]."""
    texture = torch.as_tensor(texture, dtype=torch.float32)
    squeeze = texture.dim() == 2
    if squeeze:
        texture = texture[..., None]
    H, W, C = texture.shape
    px = pos[..., 0] * (W - 1)
    py = pos[..., 1] * (H - 1)
    oob = (px < 0) | (px > W - 1) | (py < 0) | (py > H - 1)
    x0 = px.to(torch.int64).clamp(0, W - 1)
    y0 = py.to(torch.int64).clamp(0, H - 1)
    x1 = (x0 + 1).clamp(0, W - 1)
    y1 = (y0 + 1).clamp(0, H - 1)
    wx1 = px - x0
    wx0 = 1 - wx1
    wy1 = py - y0
    wy0 = 1 - wy1
    val = (texture[y0, x0] * (wx0 * wy0)[..., None] +
           texture[y1, x0] * (wx0 * wy1)[..., None] +
           texture[y0, x1] * (wx1 * wy0)[..., None] +
           texture[y1, x1] * (wx1 * wy1)[..., None])
    val = torch.where(oob[..., None], default, val)
    return val[..., 0] if squeeze else val


def conv_for_image(x, w, overflow=0.0):
    """Dense 2-D correlation with ``overflow`` outside the image (conv.py:5-21)."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[..., None]
    w = torch.as_tensor(w, dtype=torch.float32, device=x.device)
    Kh, Kw = w.shape
    ph, pw = Kh // 2, Kw // 2
    xp = Fn.pad(x.permute(2, 0, 1)[:, None], (pw, Kw - 1 - pw, ph, Kh - 1 - ph),
                value=float(overflow))
    out = Fn.conv2d(xp, w[None, None])[:, 0].permute(1, 2, 0)
    return out[..., 0] if squeeze else out


def gaussian_blur(image, tap_num, v, modulate_map, dim=0):
    """Stretch-modulated separable blur of SSS (gaussian_blur.py); dim=1
    blurs along x, dim=0 along y."""
    squeeze = image.dim() == 2
    img = image[..., None] if squeeze else image
    H, W, C = img.shape
    gw = math.sqrt(v)
    taps = [float(np.float32(gw * (math.exp(-(-gw * ((tap_num - 1) / 2 - i)) ** 2 / (2 * v))
                                   / math.sqrt(2 * math.pi * v))))
            for i in range(tap_num)]

    mod = modulate_map if modulate_map.dim() == 2 else modulate_map[..., 0]
    nfw = gw * mod                                                  # [H,W]
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=img.device),
                            torch.arange(W, dtype=torch.float32, device=img.device),
                            indexing='ij')
    base = (xs if dim == 1 else ys) - nfw * (tap_num - 1) / 2

    center = img
    nonzero = (center > 0).any(dim=-1, keepdim=True)
    rows, cols = ys.to(torch.int64), xs.to(torch.int64)
    acc = torch.zeros_like(img)
    pos = base
    for k in range(tap_num):
        lo = pos.to(torch.int64)
        if dim == 1:
            i1, i2 = lo.clamp(0, W - 1), (lo + 1).clamp(0, W - 1)
            v1, v2 = img[rows, i1], img[rows, i2]
        else:
            i1, i2 = lo.clamp(0, H - 1), (lo + 1).clamp(0, H - 1)
            v1, v2 = img[i1, cols], img[i2, cols]
        v1 = torch.where(v1 > 1e-6, v1, center)
        v2 = torch.where(v2 > 1e-6, v2, center)
        interp = (pos - i1.float())[..., None] * v2 + (i2.float() - pos)[..., None] * v1
        acc = acc + interp * taps[k]
        pos = pos + nfw
    out = torch.where(nonzero, acc, 0.0)
    return out[..., 0] if squeeze else out


def compute_stretch_map(world_map, padding_method='replicate'):
    """SSS stretch maps from world-coordinate derivatives (ToStretchMap.py:5-13)."""
    wx = torch.cat([world_map, world_map[:, -1:, :]], dim=1)
    wy = torch.cat([world_map, world_map[-1:, :, :]], dim=0)
    stretchU = 1.0 / torch.sqrt(((world_map - wx[:, 1:]) ** 2).sum(-1))
    stretchV = 1.0 / torch.sqrt(((world_map - wy[1:]) ** 2).sum(-1))
    return stretchU, stretchV


# -- shadows ----------------------------------------------------------------

SCAN_BLOCK = 16


def _running(x, op):
    """Inclusive prefix ``op`` along the last dim, applied left to right."""
    outs = [x[..., 0]]
    for k in range(1, x.shape[-1]):
        outs.append(op(outs[-1], x[..., k]))
    return torch.stack(outs, -1)


def _blocked_scan(x, op, identity):
    """Inclusive scan of ``op`` along the last dim in blocks of SCAN_BLOCK,
    each block's offset the scan (the same way, recursively) of the blocks'
    totals."""
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        return _running(x, op)
    m = -(-n // SCAN_BLOCK)
    xp = Fn.pad(x, (0, m * SCAN_BLOCK - n), value=identity)
    inner = _running(xp.reshape(*x.shape[:-1], m, SCAN_BLOCK), op)
    offset = Fn.pad(_blocked_scan(inner[..., -1], op, identity)[..., :-1], (1, 0),
                    value=identity)
    return op(inner, offset[..., None]).reshape(*x.shape[:-1], m * SCAN_BLOCK)[..., :n]


def prefix_sum(x, dim):
    """Inclusive prefix sums of float32 ``x`` along ``dim``, added in a fixed
    order: blocks of SCAN_BLOCK left to right, each block's offset the
    scan (the same way, recursively) of the blocks' totals.  That is the
    order of the JAX package's ``jnp.cumsum`` on the CPU (XLA rewrites its
    long reduce-window so), so both give the same bits; ``torch.cumsum``
    accumulates in float64 on the CPU and in float32 on the card."""
    return _blocked_scan(x.movedim(dim, -1), torch.add, 0.0).movedim(-1, dim)


def prefix_prod(x, dim):
    """Inclusive prefix products of float32 ``x`` along ``dim`` in
    ``prefix_sum``'s order, which is that of ``jnp.cumprod`` on the CPU
    (``torch.cumprod`` multiplies in another order)."""
    return _blocked_scan(x.movedim(dim, -1), torch.mul, 1.0).movedim(-1, dim)


def generate_SAT(image):
    """Summed-area table, SAT[y, x] = sum of image[:y+1, :x+1], in float32
    (the reference sums in float64; texture.py:115-139), by ``prefix_sum``."""
    return prefix_sum(prefix_sum(torch.as_tensor(image, dtype=torch.float32), 0), 1)


def _gather_index(i, n):
    """An index as a JAX gather reads it: a negative one counts from the
    end, and what is still out of range is clamped."""
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def _region_mean(SAT, x, y, offset, is_):
    xp1 = (x - offset - 1).clamp_min(0)
    yp1 = (y - offset - 1).clamp_min(0)
    xp2 = (x + offset).clamp_max(is_ - 1)
    yp2 = (y + offset).clamp_max(is_ - 1)
    H, W = SAT.shape
    r1, r2 = _gather_index(yp1, H), _gather_index(yp2, H)
    c1, c2 = _gather_index(xp1, W), _gather_index(xp2, W)
    s = SAT[r2, c2] - SAT[r1, c2] - SAT[r2, c1] + SAT[r1, c1]
    return s / ((xp2 - xp1) * (yp2 - yp1)).clamp_min(1).to(s.dtype)


def _chebyshev(mean, variance, upper):
    a = upper - mean
    denom = (a * a).clamp_min(1e-5)
    return (variance / (variance + denom)).clamp(0.0, 1.0)


def VSSM(eyeDepth, SAT, SAT2, uv, light, side_length=0.08):
    """Variance soft shadow mapping (VSSM_cuda.py:23-118)."""
    is_ = eyeDepth.shape[0]
    near, far = light.near, light.far
    sm_sl = math.tan(light.viewing_angle / 180.0 * math.pi)

    u = uv[..., 0]
    v = uv[..., 1]
    upper = 1 - 1 / is_
    in_map = (u >= 0) & (u <= upper) & (v >= 0) & (v <= upper)
    z = eyeDepth
    z_ok = (z >= near) & (z <= far)

    xp = (u * is_).to(torch.int64)
    yp = (v * is_).to(torch.int64)

    bs_sl = (side_length / z * (z - 1).abs()).clamp_max(sm_sl)
    s_off = (bs_sl / sm_sl / 2 * is_).clamp(0.0, is_ / 2).to(torch.int64)
    z_avg = _region_mean(SAT, xp, yp, s_off, is_)
    z2_avg = _region_mean(SAT2, xp, yp, s_off, is_)
    fully_lit = z < z_avg + 0.01
    occlusion = 1.0 - _chebyshev(z_avg, z2_avg - z_avg * z_avg, z)
    occ_z = (z_avg - (1 - occlusion) * z) / occlusion.clamp_min(1e-6)
    occ_z = occ_z.clamp(near, far)
    filt = (z - occ_z) / occ_z * side_length
    f_off = (filt / sm_sl / 2 * is_).clamp(0.0, is_ / 2).to(torch.int64)
    fz = _region_mean(SAT, xp, yp, f_off, is_)
    fz2 = _region_mean(SAT2, xp, yp, f_off, is_)
    lit2 = z < fz + 0.005
    vis = _chebyshev(fz, fz2 - fz * fz, z).clamp(0.0, 1.0)
    out = torch.where(lit2, 1.0, vis)
    out = torch.where(fully_lit, 1.0, out)
    return torch.where(in_map & z_ok, out, 1.0)


# -- ambient occlusion ------------------------------------------------------

def _pixel_tbn(N):
    """Per-pixel tangent frame (SSAO_cuda.py:126-139)."""
    big = (N[..., 0].abs() > 0.5) | (N[..., 1].abs() > 0.5)
    zero = torch.zeros_like(N[..., 0])
    T1 = torch.stack([-N[..., 1], N[..., 0], zero], -1)
    T2 = torch.stack([N[..., 2], zero, -N[..., 0]], -1)
    T = normalize(torch.where(big[..., None], T1, T2), axis=-1)
    B = torch.linalg.cross(T, N, dim=-1)
    return T, B


def _hemisphere_samples(r):
    """The sample offsets (px, py, pz) from uniform draws r [n, 3]."""
    randr = torch.sqrt(r[:, 2] / 3)
    px = randr * r[:, 1] * torch.cos(2 * math.pi * r[:, 0])
    py = randr * torch.sqrt(1 - r[:, 1] ** 2)
    pz = randr * r[:, 1] * torch.sin(2 * math.pi * r[:, 0])
    return px, py, pz


def _occlusion_setup(depth, normals, width, sample_num, samples, generator):
    is_ = depth.shape[0]
    _, _, xi, yi = _pixel_ndc(is_, depth.device)
    wc = torch.stack([xi * width * depth, yi * width * depth, depth], -1)
    T, B = _pixel_tbn(normals)
    r = _uniform((sample_num, 3), depth.device, samples, generator)
    return wc, T, B, _hemisphere_samples(r)


def _occlusion_sample(depth, wc, T, N, B, width, sample_range_r, pk):
    """(occluded [H,W] bool, sample row, sample column) of one sample."""
    is_ = depth.shape[0]
    px, py, pz = pk
    p = (px * T + py * N + pz * B) * sample_range_r + wc
    sx = torch.round(is_ * (p[..., 0] / p[..., 2] / width + 1) / 2).to(torch.int64)
    sy = is_ - torch.round(is_ * (p[..., 1] / p[..., 2] / width + 1) / 2).to(torch.int64)
    inb = (sx >= 0) & (sx < is_) & (sy >= 0) & (sy < is_)
    syc, sxc = sy.clamp(0, is_ - 1), sx.clamp(0, is_ - 1)
    return inb & (depth[syc, sxc] < p[..., 2]), syc, sxc


def SSAO(depth, faces_ind, normals, width, sample_num=256, sample_range_r=0.25,
         samples=None, generator=None):
    """Screen-space ambient occlusion (SSAO_cuda.py:109-171): per-pixel
    occlusion in [0,1]."""
    wc, T, B, (px, py, pz) = _occlusion_setup(depth, normals, width, sample_num,
                                              samples, generator)
    occ = torch.zeros_like(depth)
    for k in range(sample_num):
        hit, _, _ = _occlusion_sample(depth, wc, T, normals, B, width, sample_range_r,
                                      (px[k], py[k], pz[k]))
        occ = occ + hit.float()
    return torch.where(faces_ind >= 0, occ / sample_num, 0.0)


def SSDO(color, depth, faces_ind, normals, width, sample_num=1024,
         sample_range_r=0.3, samples=None, generator=None):
    """Directional occlusion: gathers the occluders' colour (SSDO_cuda.py)."""
    wc, T, B, (px, py, pz) = _occlusion_setup(depth, normals, width, sample_num,
                                              samples, generator)
    acc = torch.zeros_like(color)
    for k in range(sample_num):
        hit, syc, sxc = _occlusion_sample(depth, wc, T, normals, B, width, sample_range_r,
                                          (px[k], py[k], pz[k]))
        acc = acc + color[syc, sxc] * hit[..., None]
    return color + torch.where((faces_ind >= 0)[..., None], acc / sample_num, 0.0)


# -- screen-space reflections ----------------------------------------------

def _ssr_mask(faces_ind, ssr_faces):
    """A pixel belongs to a reflective object: faces_ind in any [lo, hi)."""
    m = torch.zeros(faces_ind.shape, dtype=torch.bool, device=faces_ind.device)
    ssr_faces = [int(v) for v in np.asarray(ssr_faces).reshape(-1)]
    for j in range(len(ssr_faces) // 2):
        m = m | ((faces_ind >= ssr_faces[2 * j]) & (faces_ind < ssr_faces[2 * j + 1]))
    return m


def _signed_floor(x, lim):
    """x pushed away from zero to at least lim (positive x up, else down)."""
    return torch.where(x > 0, x.clamp_min(lim), x.clamp_max(-lim))


def _reflection_setup(world_buffer, normal_buffer, width, world_thickness, c_step):
    """The rays' screen start and direction, shared by SSR and SSR_hiz.
    ``c_step`` None: SSR's guard on the step slope (``sy == 0 -> 1e-6``);
    else SSR_hiz's (|s| at least c_step)."""
    is_ = world_buffer.shape[0]
    depth = world_buffer[..., 2]
    ys, xs, xi, yi = _pixel_ndc(is_, world_buffer.device)
    wcoord = torch.stack([xi * depth * width, yi * depth * width, depth], -1)
    indir = normalize(wcoord, axis=-1)
    N = normal_buffer
    outdir = normalize(indir - 2 * (indir * N).sum(-1, keepdim=True) * N, axis=-1)

    w0 = wcoord + world_thickness * outdir
    w0p = torch.stack([w0[..., 0] / w0[..., 2] / width, w0[..., 1] / w0[..., 2] / width], -1)
    stepdir = w0p - torch.stack([xi, yi], -1)
    stepdir = stepdir / torch.linalg.vector_norm(stepdir, dim=-1, keepdim=True).clamp_min(1e-12)

    sx, sy = stepdir[..., 0], stepdir[..., 1]
    step_axis = sy.abs() > sx.abs()                     # True: walk y
    if c_step is None:
        step_k = torch.where(step_axis, sx / torch.where(sy == 0, 1e-6, sy),
                             sy / torch.where(sx == 0, 1e-6, sx))
        lim = 1e-6
    else:
        step_k = torch.where(step_axis, sx / _signed_floor(sy, c_step),
                             sy / _signed_floor(sx, c_step))
        lim = c_step
    step_pos = torch.where(step_axis, sy > 0, sx > 0)

    ox, oy = outdir[..., 0], outdir[..., 1]
    k_axis = oy.abs() > ox.abs()
    ray_k = torch.where(k_axis, ox / _signed_floor(oy, lim), oy / _signed_floor(ox, lim))
    numer = torch.where(k_axis, yi * ray_k - xi, xi * ray_k - yi) * wcoord[..., 2]
    return dict(depth=depth, xs=xs, ys=ys, step_axis=step_axis, step_k=step_k,
                step_pos=step_pos, k_axis=k_axis, ray_k=ray_k, numer=numer,
                ray_depth=wcoord[..., 2])


def _ray_depth(nxt_x, nxt_y, r, is_):
    rxi = (2 * nxt_x + 1 - is_) / is_
    ryi = (2 * nxt_y + 1 - is_) / is_
    den = torch.where(r['k_axis'], ryi * r['ray_k'] - rxi, rxi * r['ray_k'] - ryi)
    return r['numer'] / _signed_floor(den, 1e-5)


def _march_ssr(r, is_, mask, far, step, max_steps, world_thickness):
    """SSR's DDA march: (hit [H,W] bool, hit pixel index [H,W])."""
    depth = r['depth']
    ray_x = r['xs'].float()
    ray_y = (is_ - 1 - r['ys']).float()
    done = ~mask
    hit = torch.zeros_like(mask)
    hit_ind = torch.zeros(mask.shape, dtype=torch.int64, device=mask.device)
    ray_depth = r['ray_depth']
    step_pos, step_k, step_axis = r['step_pos'], r['step_k'], r['step_axis']

    def walk(r0, r1):
        p0 = torch.where(step_pos, torch.floor((r0 + 1) / step), torch.floor((r0 - 1) / step))
        n0 = torch.where(step_pos, (p0 + 1) * step - 0.5, p0 * step + 0.5)
        return n0, (n0 - r0) * step_k + r1

    for i in range(max_steps):
        if i % DONE_CHECK == 0 and bool(done.all()):
            break
        nx_y, ny_y = walk(ray_y, ray_x)                 # a step in y
        nx_x, ny_x = walk(ray_x, ray_y)                 # a step in x
        nxt_x = torch.where(step_axis, ny_y, nx_x)
        nxt_y = torch.where(step_axis, nx_y, ny_x)

        off = (nxt_y > is_ - 1) | (nxt_y < 0) | (nxt_x > is_ - 1) | (nxt_x < 0) \
            | (ray_depth > far)
        row = is_ - nxt_y.clamp(0, is_ - 1).to(torch.int64) - 1
        col = nxt_x.clamp(0, is_ - 1).to(torch.int64)
        z = depth[row, col]
        rd = _ray_depth(nxt_x, nxt_y, r, is_)

        hit_now = (rd > z) & (rd <= far) & (rd < z + world_thickness) & ~done & ~off
        ray_x = torch.where(done, ray_x, nxt_x)
        ray_y = torch.where(done, ray_y, nxt_y)
        ray_depth = torch.where(done, ray_depth, rd)
        hit = hit | hit_now
        hit_ind = torch.where(hit_now, row * is_ + col, hit_ind)
        done = done | off | hit_now
    return hit, hit_ind


def SSR(color, world_buffer, normal_buffer, faces_ind_buffer, ssr_faces,
        width, far, step=1, max_steps=256, world_thickness=0.1,
        reflect_strength=0.6):
    """Screen-space mirror reflections (SSR_cuda.py naive2 :7-262).

    DDA-marches the projected reflection ray; on a depth-interval hit adds
    ``reflect_strength`` times the hit pixel's colour, per channel (the
    reference adds its red channel to every channel, SSR_cuda.py:211-213,
    which the JAX package corrects too)."""
    is_ = color.shape[0]
    mask = _ssr_mask(faces_ind_buffer, ssr_faces)
    r = _reflection_setup(world_buffer, normal_buffer, width, world_thickness, None)
    hit, hit_ind = _march_ssr(r, is_, mask, far, step, max_steps, world_thickness)
    hit_col = color.reshape(-1, 3)[hit_ind]
    return torch.where(hit[..., None], color + reflect_strength * hit_col, color)


def _min_depth_pyramid(depth):
    """Min-pooled Hi-Z pyramid flattened into one buffer: (flat, offsets,
    sizes); level 0 is ``depth``, each next level 2x2-min-pools the previous
    (SSR_cuda.py:261-286)."""
    s = depth.shape[0]
    levels = [depth]
    while s > 1:
        levels.append(levels[-1].reshape(s // 2, 2, s // 2, 2).amin(dim=(1, 3)))
        s //= 2
    flat = torch.cat([lv.reshape(-1) for lv in levels])
    sizes = np.array([lv.shape[0] for lv in levels], np.int64)
    offsets = np.concatenate([[0], np.cumsum([lv.numel() for lv in levels])[:-1]]).astype(np.int64)
    dev = depth.device
    return flat, torch.as_tensor(offsets, device=dev), torch.as_tensor(sizes, device=dev)


def SSR_hiz(color, world_buffer, normal_buffer, faces_ind_buffer, ssr_faces,
            width, far, level_intersect=0, max_steps=128,
            world_thickness=0.1, pixel_bias=0.04, reflect_strength=0.4):
    """Hi-Z (mipmap-accelerated) screen-space reflections (SSR_cuda.py:260-540).

    Marches the projected reflection ray against a min-pooled depth
    pyramid: each step jumps to the next cell boundary of the current
    level; passing below the depth descends a level, a clear step ascends
    one, and hits count only at ``level <= level_intersect``.  Needs a
    power-of-two image size.  As in the JAX package, a hit blends
    ``(1-s) * base + s * hit`` per channel, pixels off the mirrors keep
    their colour, and ``max_steps`` bounds the march."""
    is_ = color.shape[0]
    assert is_ & (is_ - 1) == 0, 'Hi-Z SSR needs a power-of-two image size'
    mask = _ssr_mask(faces_ind_buffer, ssr_faces)
    r = _reflection_setup(world_buffer, normal_buffer, width, world_thickness, 1e-5)
    flat_z, offsets, sizes = _min_depth_pyramid(r['depth'])
    intervals = 2.0 ** torch.arange(sizes.shape[0], device=color.device, dtype=torch.float32)
    step_pos, step_k, step_axis = r['step_pos'], r['step_k'], r['step_axis']

    ray_x = r['xs'].float()
    ray_y = (is_ - 1 - r['ys']).float()
    level = torch.zeros(mask.shape, dtype=torch.int64, device=mask.device)
    ray_depth = r['ray_depth']
    done = ~mask
    hit = torch.zeros_like(mask)
    hit_ind = torch.zeros(mask.shape, dtype=torch.int64, device=mask.device)

    for i in range(max_steps):
        if i % DONE_CHECK == 0 and bool(done.all()):
            break
        interval = intervals[level]
        dsize = sizes[level]
        dead = (ray_depth > far) | (ray_depth < 0)
        active = ~done & ~dead

        def walk(r0, r1):
            p0 = torch.where(step_pos, torch.floor((r0 + 1) / interval),
                             torch.floor((r0 - 1) / interval))
            n0 = torch.where(step_pos, (p0 + 1) * interval - 0.5, p0 * interval + 0.5)
            return n0, (n0 - r0) * step_k + r1
        ny_w, nx_w = walk(ray_y, ray_x)                 # walked in y
        nx_v, ny_v = walk(ray_x, ray_y)                 # walked in x
        nxt_x = torch.where(step_axis, nx_w, nx_v)
        nxt_y = torch.where(step_axis, ny_w, ny_v)
        hz_x = torch.floor(nxt_x / interval).to(torch.int64)
        hz_y = torch.floor(nxt_y / interval).to(torch.int64)

        off = (hz_x < 0) | (hz_x >= dsize) | (hz_y < 0) | (hz_y >= dsize)
        hy = torch.minimum(hz_y.clamp_min(0), dsize - 1)
        hx = torch.minimum(hz_x.clamp_min(0), dsize - 1)
        z = flat_z[offsets[level] + (dsize - hy - 1) * dsize + hx]
        rd = _ray_depth(nxt_x, nxt_y, r, is_)

        at_base = level <= level_intersect
        probe = active & ~off
        below = probe & (rd > z + pixel_bias)
        advance = probe & ~below
        miss_off = active & off & at_base
        finer = (active & off & ~at_base) | (below & ~(at_base & (rd <= far)))
        hit_try = below & at_base & (rd <= far)
        hit_now = hit_try & (rd <= z + world_thickness)
        coarser = advance & (dsize != 1)

        row = is_ - 1 - nxt_y.to(torch.int64).clamp(0, is_ - 1)
        col = nxt_x.to(torch.int64).clamp(0, is_ - 1)
        ray_x = torch.where(advance, nxt_x, ray_x)
        ray_y = torch.where(advance, nxt_y, ray_y)
        level = level - finer.to(torch.int64) + coarser.to(torch.int64)
        ray_depth = torch.where(probe, rd, ray_depth)
        done = done | dead | miss_off | hit_try
        hit = hit | hit_now
        hit_ind = torch.where(hit_now, row * is_ + col, hit_ind)

    hit_col = color.reshape(-1, 3)[hit_ind]
    return torch.where(hit[..., None],
                       (1 - reflect_strength) * color + reflect_strength * hit_col, color)


def SSSR(color, world_buffer, normal_buffer, roughness_buffer, faces_ind_buffer,
         ssr_faces, width, far, step=1, spp=32, max_steps=128, samples=None,
         generator=None):
    """Stochastic glossy reflections (SSSR_cuda.py): GGX importance-sampled
    half-vectors, each reflected ray marched like SSR, averaged.
    ``samples``: uniform draws [spp, 2, H, W]."""
    is_ = color.shape[0]
    mask = _ssr_mask(faces_ind_buffer, ssr_faces)
    N = normal_buffer
    rough = roughness_buffer[..., 0] if roughness_buffer.dim() == 3 else roughness_buffer
    u = _uniform((spp, 2) + tuple(rough.shape), color.device, samples, generator)

    depth = world_buffer[..., 2]
    _, _, xi, yi = _pixel_ndc(is_, color.device)
    wcoord = torch.stack([xi * depth * width, yi * depth * width, depth], -1)
    V = -normalize(wcoord, axis=-1)
    T, B = _pixel_tbn(N)
    a = rough * rough

    acc = torch.zeros_like(color)
    for k in range(spp):
        u1, u2 = u[k, 0], u[k, 1]
        # GGX half-vector sampling
        cos_t = torch.sqrt((1 - u1) / (1 + (a * a - 1) * u1 + 1e-9))
        sin_t = torch.sqrt((1 - cos_t ** 2).clamp_min(0))
        phi = 2 * math.pi * u2
        H = (sin_t * torch.cos(phi))[..., None] * T + cos_t[..., None] * N + \
            (sin_t * torch.sin(phi))[..., None] * B
        H = normalize(H, axis=-1)
        L = normalize(2 * (V * H).sum(-1, keepdim=True) * H - V, axis=-1)
        # march along L with SSR, its normals chosen so that reflect(indir) == L
        n_fake = normalize(L + V, axis=-1)
        refl = SSR(color, world_buffer, n_fake, faces_ind_buffer, ssr_faces,
                   width, far, step=step, max_steps=max_steps, reflect_strength=1.0)
        acc = acc + (refl - color)
    return torch.where(mask[..., None], acc / spp, 0.0)


def bilateral_filter(img, d=5, sigma_color=20 / 255.0, sigma_space=10.0):
    """Small bilateral filter (replaces the reference's cv2 post-pass)."""
    r = d // 2
    H, W, C = img.shape
    acc = torch.zeros_like(img)
    wsum = torch.zeros((H, W, 1), device=img.device)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            shifted = torch.roll(img, (dy, dx), dims=(0, 1))
            sw = math.exp(-(dx * dx + dy * dy) / (2 * sigma_space ** 2))
            cw = torch.exp(-((shifted - img) ** 2).sum(-1, keepdim=True) /
                           (2 * sigma_color ** 2))
            w = sw * cw
            acc = acc + shifted * w
            wsum = wsum + w
    return acc / wsum.clamp_min(1e-9)


# -- FXAA -------------------------------------------------------------------

EDGE_THRESHOLD_MIN = 0.0312
EDGE_THRESHOLD_MAX = 0.125
FXAA_ITERATIONS = 12
SUBPIXEL_QUALITY = 0.75
_QUALITY = [1.0, 1.0, 1.0, 1.0, 1.0, 1.5, 2.0, 2.0, 2.0, 2.0, 4.0, 8.0]


def FXAA(texture):
    """FXAA 3.11 post-AA (FXAA_cuda.py:3-260); texture [H,W,3] with the
    reference's flipped-y sampling convention."""
    is_ = texture.shape[0]

    def tex(x, y):
        x = x.clamp(0.0, is_ - 1.0)
        y = y.clamp(0.0, is_ - 1.0)
        yy = is_ - 1 - y
        x0 = x.to(torch.int64)
        y0 = yy.to(torch.int64)
        x1 = (x0 + 1).clamp(0, is_ - 1)
        y1 = (y0 + 1).clamp(0, is_ - 1)
        wx1 = (x - x0)[..., None]
        wy1 = (yy - y0)[..., None]
        return (texture[y0, x0] * (1 - wx1) * (1 - wy1) +
                texture[y1, x0] * (1 - wx1) * wy1 +
                texture[y0, x1] * wx1 * (1 - wy1) +
                texture[y1, x1] * wx1 * wy1)

    def luma(rgb):
        return torch.sqrt(rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114)

    ys, xs = torch.meshgrid(torch.arange(is_, dtype=torch.float32, device=texture.device),
                            torch.arange(is_, dtype=torch.float32, device=texture.device),
                            indexing='ij')
    ux = xs
    uy = is_ - 1 - ys

    cC = tex(ux, uy)
    lC = luma(cC)
    lL = luma(tex(ux - 1, uy))
    lR = luma(tex(ux + 1, uy))
    lU = luma(tex(ux, uy + 1))
    lD = luma(tex(ux, uy - 1))
    lmin = torch.minimum(lC, torch.minimum(torch.minimum(lD, lU), torch.minimum(lL, lR)))
    lmax = torch.maximum(lC, torch.maximum(torch.maximum(lD, lU), torch.maximum(lL, lR)))
    lrange = lmax - lmin
    no_aa = lrange < (lmax * EDGE_THRESHOLD_MAX).clamp_min(EDGE_THRESHOLD_MIN)

    lUL = luma(tex(ux - 1, uy + 1))
    lUR = luma(tex(ux + 1, uy + 1))
    lDL = luma(tex(ux - 1, uy - 1))
    lDR = luma(tex(ux + 1, uy - 1))

    lDU = lD + lU
    lLR = lL + lR
    lLC = lDL + lUL
    lDC = lDL + lDR
    lRC = lDR + lUR
    lUC = lUR + lUL

    edge_h = (-2 * lL + lLC).abs() + (-2 * lC + lDU).abs() * 2 + (-2 * lR + lRC).abs()
    edge_v = (-2 * lU + lUC).abs() + (-2 * lC + lLR).abs() * 2 + (-2 * lD + lDC).abs()
    is_horizontal = edge_h >= edge_v

    l1 = torch.where(is_horizontal, lD, lL)
    l2 = torch.where(is_horizontal, lU, lR)
    g1 = (l1 - lC).abs()
    g2 = (l2 - lC).abs()
    steepest1 = g1 >= g2
    grad_scaled = 0.25 * torch.maximum(g1, g2)
    step_len = torch.where(steepest1, -1.0, 1.0)
    lavg_local = torch.where(steepest1, 0.5 * (l1 + lC), 0.5 * (l2 + lC))

    cx = ux + torch.where(is_horizontal, 0.0, step_len * 0.5)
    cy = uy + torch.where(is_horizontal, step_len * 0.5, 0.0)
    offx = torch.where(is_horizontal, 1.0, 0.0)
    offy = torch.where(is_horizontal, 0.0, 1.0)

    ux1 = cx - offx
    uy1 = cy - offy
    ux2 = cx + offx
    uy2 = cy + offy
    le1 = luma(tex(ux1, uy1)) - lavg_local
    le2 = luma(tex(ux2, uy2)) - lavg_local
    reached1 = le1.abs() >= grad_scaled
    reached2 = le2.abs() >= grad_scaled
    for it in range(1, FXAA_ITERATIONS):
        q = _QUALITY[it]
        ux1 = torch.where(reached1, ux1, ux1 - offx * q)
        uy1 = torch.where(reached1, uy1, uy1 - offy * q)
        ux2 = torch.where(reached2, ux2, ux2 + offx * q)
        uy2 = torch.where(reached2, uy2, uy2 + offy * q)
        le1 = torch.where(reached1, le1, luma(tex(ux1, uy1)) - lavg_local)
        le2 = torch.where(reached2, le2, luma(tex(ux2, uy2)) - lavg_local)
        reached1 = reached1 | (le1.abs() >= grad_scaled)
        reached2 = reached2 | (le2.abs() >= grad_scaled)

    d1 = torch.where(is_horizontal, ux - ux1, uy - uy1)
    d2 = torch.where(is_horizontal, ux2 - ux, uy2 - uy)
    dir1 = d1 < d2
    dist_final = torch.minimum(d1, d2)
    edge_len = d1 + d2
    pixel_off = -dist_final / edge_len.clamp_min(1e-6) + 0.5

    is_center_smaller = lC < lavg_local
    correct_var = torch.where(dir1, (le1 < 0) != is_center_smaller,
                              (le2 < 0) != is_center_smaller)
    final_off = torch.where(correct_var, pixel_off, 0.0)

    # subpixel
    lavg = (1.0 / 12.0) * (2 * (lDU + lLR) + lLC + lRC)
    sub1 = ((lavg - lC).abs() / lrange.clamp_min(1e-6)).clamp(0, 1)
    sub2 = (-2 * sub1 + 3) * sub1 * sub1
    sub_off = sub2 * sub2 * SUBPIXEL_QUALITY
    final_off = torch.maximum(final_off, sub_off)

    fx = ux + torch.where(is_horizontal, 0.0, final_off * step_len)
    fy = uy + torch.where(is_horizontal, final_off * step_len, 0.0)
    return torch.where(no_aa[..., None], cC, tex(fx, fy))
