"""Shared geometric primitives of the SoftRas rasterizer (plain PyTorch).

Counterpart of ``jrender_tpu/ops/softras/geometry.py``.  These reproduce,
in broadcast form, the device functions of the reference kernels
(soft_rasterize.py):
  * face_info preprocess (face_inv/face_sym/face_obt) -- :176-236
  * barycentric_coordinate -- :21
  * check_border -- :29 / check_face_frontside -- :37
  * forward_barycentric_p2f_distance -- :150
  * euclidean_p2f_distance -- :57-147 (with obtuse-vertex casework)
  * barycentric_clip -- :50, perspective depth -- :364
  * forward_sample_texture -- :156-173

Everything works on tensors whose last axes are the face-local dims, with
arbitrary leading broadcast dims.  ``csrc/softras_pair.cuh`` holds the
same math per (pixel, face) pair for the CUDA kernel.
"""
from __future__ import annotations

import torch


def _safe_div(a, b, eps=1e-30):
    """Division that never produces NaN/Inf from a zero denominator."""
    b_safe = torch.where(b.abs() < eps,
                         torch.where(b < 0, torch.full_like(b, -eps),
                                     torch.full_like(b, eps)), b)
    return a / b_safe


def border_inflation(threshold: float) -> float:
    """sqrt(threshold) as the JAX oracle computes it (float32 sqrt of the
    float32 threshold): the bbox inflation of the border test and of the
    binning."""
    return float(torch.tensor(threshold, dtype=torch.float32).sqrt())


def face_info_preprocess(face: torch.Tensor):
    """(face_inv [...,9], face_sym [...,9], face_obt [...,3]) from face [...,9].

    face layout: [x0,y0,z0, x1,y1,z1, x2,y2,z2].
    """
    x0, y0 = face[..., 0], face[..., 1]
    x1, y1 = face[..., 3], face[..., 4]
    x2, y2 = face[..., 6], face[..., 7]

    inv_star = torch.stack([
        y1 - y2, x2 - x1, x1 * y2 - x2 * y1,
        y2 - y0, x0 - x2, x2 * y0 - x0 * y2,
        y0 - y1, x1 - x0, x0 * y1 - x1 * y0,
    ], dim=-1)
    det = x2 * (y0 - y1) + x0 * (y1 - y2) + x1 * (y2 - y0)
    det = torch.where(det > 0, det.clamp_min(1e-10), det.clamp_max(-1e-10))
    face_inv = inv_star / det[..., None]

    # F*F^T + 1 restricted to xy (9 values)
    px = torch.stack([x0, x1, x2], dim=-1)
    py = torch.stack([y0, y1, y2], dim=-1)
    face_sym = (px[..., :, None] * px[..., None, :] +
                py[..., :, None] * py[..., None, :] + 1.0)
    face_sym = face_sym.reshape(face_sym.shape[:-2] + (9,))

    # obtuse-corner flags; the reference loop breaks after the FIRST
    # obtuse corner (soft_rasterize.py:227-235), so at most one is set
    p = torch.stack([torch.stack([x0, y0], -1), torch.stack([x1, y1], -1),
                     torch.stack([x2, y2], -1)], dim=-2)          # [...,3,2]
    obts = []
    for k in range(3):
        k1, k2 = (k + 1) % 3, (k + 2) % 3
        d = ((p[..., k1, :] - p[..., k, :]) *
             (p[..., k2, :] - p[..., k, :])).sum(-1)
        obts.append(d < 0)
    obt = torch.stack(obts, dim=-1)
    first = torch.cumsum(obt.to(torch.int32), dim=-1) <= 1
    face_obt = (obt & first).to(face.dtype)
    return face_inv, face_sym, face_obt


def fma(a, b, c):
    """a * b + c rounded once, as a fused multiply-add does.  The product
    of two float32 values is exact in float64; the sum is rounded to odd
    there (TwoSum gives its error), so the rounding to float32 that follows
    is the only one.  float64 inputs stay float64 (rounded twice)."""
    out = torch.promote_types(a.dtype, b.dtype)
    hi, c = a.double() * b.double(), c.double()
    s = hi + c
    if out == torch.float64:
        return s
    bb = s - hi
    err = (hi - (s - bb)) + (c - bb)
    away = torch.nextafter(s, torch.copysign(torch.full_like(s, torch.inf), err))
    return torch.where((err != 0) & (s.view(torch.int64) & 1 == 0), away, s).to(out)


def barycentric_coordinate(face_inv, xp, yp):
    """w_k = inv[3k]*x + inv[3k+1]*y + inv[3k+2]; face_inv [...,9] -> w [...,3].

    Rounded as fma(inv[3k], x, inv[3k+1]*y) + inv[3k+2], the contraction
    XLA applies to the JAX oracle's expression on the CPU; the CUDA kernel
    computes the same.  For a sliver face the coefficients are large and
    the two roundings of the plain expression can move w across the
    inside tests and the texel boundaries."""
    inv = face_inv.reshape(face_inv.shape[:-1] + (3, 3))
    return fma(inv[..., 0], xp[..., None], inv[..., 1] * yp[..., None]) + inv[..., 2]


def check_border_outside(xp, yp, face, threshold):
    """True when the pixel is farther than ``threshold`` outside the face bbox."""
    xs = face[..., 0::3]
    ys = face[..., 1::3]
    return ((xp > xs.amax(-1) + threshold) | (xp < xs.amin(-1) - threshold) |
            (yp > ys.amax(-1) + threshold) | (yp < ys.amin(-1) - threshold))


def check_face_frontside(face):
    return ((face[..., 7] - face[..., 1]) * (face[..., 3] - face[..., 0]) <
            (face[..., 4] - face[..., 1]) * (face[..., 6] - face[..., 0]))


def check_pixel_inside(w):
    return ((w <= 1) & (w >= 0)).all(dim=-1)


def sum3(x):
    """x[..., 0] + x[..., 1] + x[..., 2], added left to right as the CUDA
    kernels add (``__fadd_rn``); a reduction over the last axis is free to
    add in another order, which can move the last bit."""
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def dot3(a, b):
    """sum3(a * b): each product rounded on its own, then added left to
    right, as ``dot3_rn`` of csrc/softras_pair.cuh does."""
    return sum3(a * b)


def barycentric_clip(w):
    wc = w.clamp(0.0, 1.0)
    w_sum = sum3(wc)[..., None].clamp_min(1e-5)
    return wc / w_sum


def perspective_depth(w_clip, face):
    """zp = 1 / sum(w_i / z_i)  (perspective-correct depth)."""
    zs = face[..., 2::3]
    return 1.0 / sum3(w_clip / zs)


def barycentric_distance(w):
    """Signed squared distance proxy: min(w) squared, sign by inside/outside."""
    dis = w.amin(-1)
    return torch.where(dis > 0, dis * dis, -dis * dis)


def _edge_projection(w, face_sym, v0: int, clamp: bool):
    """Project the barycentric point onto edge (v0, v0+1); returns t - w.

    The shared t-computation of euclidean_p2f_distance for a static
    corner choice v0 (soft_rasterize.py:73-101 and :123-140).
    """
    v1 = (v0 + 1) % 3
    sym = face_sym.reshape(face_sym.shape[:-1] + (3, 3))
    a0 = sym[..., v0, :] - sym[..., v1, :]                        # [...,3]
    num = dot3(w, a0) - a0[..., v1]
    den = a0[..., v0] - a0[..., v1]
    t_v0 = _safe_div(num, den)
    if clamp:
        t_v0 = t_v0.clamp(0.0, 1.0)
        t_v1 = (1.0 - t_v0).clamp(0.0, 1.0)
    else:
        t_v1 = 1.0 - t_v0
    comps = [None, None, None]
    comps[v0] = t_v0
    comps[v1] = t_v1
    comps[(v0 + 2) % 3] = torch.zeros_like(t_v0)
    return torch.stack(comps, dim=-1) - w


def euclidean_p2f_distance(w, face, face_sym, face_obt, xp, yp):
    """Euclidean point-to-face distance (soft_rasterize.py:57-147).

    Returns (sign, dis_x, dis_y, t).
    """
    fx = face[..., 0::3]
    fy = face[..., 1::3]

    inside = ((w > 0) & (w < 1)).all(dim=-1)

    # -- inside branch: closest of the three edge projections -------------
    ts, diss, dxs, dys = [], [], [], []
    for k in range(3):
        t_k = _edge_projection(w, face_sym, k, clamp=False)
        dx = dot3(t_k, fx)
        dy = dot3(t_k, fy)
        ts.append(t_k)
        dxs.append(dx)
        dys.append(dy)
        diss.append(dx * dx + dy * dy)
    kmin = torch.stack(diss, -1).argmin(dim=-1)                    # first min
    t_in = torch.gather(torch.stack(ts, -2).expand(kmin.shape + (3, 3)), -2,
                        kmin[..., None, None].expand(kmin.shape + (1, 3)))[..., 0, :]
    dx_in = torch.gather(torch.stack(dxs, -1), -1, kmin[..., None])[..., 0]
    dy_in = torch.gather(torch.stack(dys, -1), -1, kmin[..., None])[..., 0]

    # -- outside branch: corner-region casework ----------------------------
    w0n = w[..., 0] <= 0
    w1n = w[..., 1] <= 0
    w2n = w[..., 2] <= 0

    def corner_shift(base, other):
        # obtuse-corner redirection: (p - p_base) . (p_other - p_base) > 0
        bx, by = fx[..., base], fy[..., base]
        ox, oy = fx[..., other], fy[..., other]
        return (xp - bx) * (ox - bx) + (yp - by) * (oy - by) > 0

    # corner picks per the cascade (soft_rasterize.py:109-121)
    c1 = w1n & w2n
    c2 = w2n & w0n & ~c1
    c3 = w0n & w1n & ~c1 & ~c2
    rest = ~(c1 | c2 | c3)
    e1 = rest & w0n
    e2 = rest & ~w0n & w1n
    e3 = rest & ~w0n & ~w1n & w2n

    def pick(cond, a, b):
        return torch.where(cond, torch.full_like(kmin, a), torch.full_like(kmin, b))

    v0_sel = torch.zeros_like(kmin)
    v0_sel = torch.where(c1, pick((face_obt[..., 0] == 1) & corner_shift(0, 2), 2, 0), v0_sel)
    v0_sel = torch.where(c2, pick((face_obt[..., 1] == 1) & corner_shift(1, 0), 0, 1), v0_sel)
    v0_sel = torch.where(c3, pick((face_obt[..., 2] == 1) & corner_shift(2, 1), 1, 2), v0_sel)
    v0_sel = torch.where(e1, torch.ones_like(v0_sel), v0_sel)
    v0_sel = torch.where(e2, torch.full_like(v0_sel, 2), v0_sel)
    v0_sel = torch.where(e3, torch.zeros_like(v0_sel), v0_sel)

    t_opts = torch.stack([_edge_projection(w, face_sym, k, clamp=True)
                          for k in range(3)], dim=-2)
    t_out = torch.gather(t_opts, -2,
                         v0_sel[..., None, None].expand(v0_sel.shape + (1, 3)))[..., 0, :]
    dx_out = dot3(t_out, fx)
    dy_out = dot3(t_out, fy)

    sign = torch.where(inside, 1.0, -1.0).to(w.dtype)
    dis_x = torch.where(inside, dx_in, dx_out)
    dis_y = torch.where(inside, dy_in, dy_out)
    t = torch.where(inside[..., None], t_in, t_out)
    return sign, dis_x, dis_y, t


def sample_texture_surface_idx(w_clip, texture_res: int):
    """Texel index for surface sampling (forward_sample_texture :156-166)."""
    R = texture_res
    w_x = (w_clip[..., 0] * R).clamp_max(float(R - 1)).to(torch.int64)
    w_y = (w_clip[..., 1] * R).clamp_max(float(R - 1)).to(torch.int64)
    low = (w_clip[..., 0] + w_clip[..., 1]) * R - w_x - w_y <= 1
    return torch.where(low, w_y * R + w_x, (R - 1 - w_y) * R + (R - 1 - w_x))
