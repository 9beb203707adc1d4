"""SoftRas in plain PyTorch, over the (pixel, face) pairs that can touch.

The semantics are the port's documented ones (``jrender_tpu_torch/ops/
softras/torch_impl.py``: ``forward_single``, ``topk_threshold``,
``backward_single``; euclidean distance, softmax rgb, prod alpha, surface
texels, double-sided faces): the soft image and aggregates, the K-th
smallest candidate depth of each pixel, and the reference's top-K truncated
backward, which is not the derivative of the forward.  The pair math is a
frozen copy of ``ops/softras/geometry.py``.

Where the port's plain version evaluates every pair of pixels and faces,
this one lists only the pixels of each face's bounding box inflated by the
border test's margin (one pixel wider for rounding), evaluates each listed
pair in one flat tensor, and reduces per pixel by scatters: the pairs it
leaves out fail the border test, so they add nothing to any output.
"""
from __future__ import annotations

import dataclasses
import math

import torch

BIG = 10000000.0
CHUNK_PAIRS = 1 << 22          # pairs evaluated at once


@dataclasses.dataclass(frozen=True)
class Params:
    image_size: int
    sigma_val: float = 1e-5
    gamma_val: float = 1e-4
    near: float = 1.0
    far: float = 100.0
    eps: float = 1e-3
    dist_eps: float = 1e-4
    background: tuple = (0.0, 0.0, 0.0)
    K: int = 16

    @property
    def threshold(self) -> float:
        return math.log(1.0 / self.dist_eps - 1.0) * self.sigma_val

    @property
    def inflation(self) -> float:
        """sqrt(threshold) in float32, the border test's margin."""
        return float(torch.tensor(self.threshold, dtype=torch.float32).sqrt())


def params_of(render: dict) -> Params:
    """The rasterizer's settings from a configuration's ``render`` block
    (``Renderer`` keyword arguments); other settings than the defaults
    below are refused."""
    fixed = {'dist_func': 'euclidean', 'aggr_func_rgb': 'softmax', 'aggr_func_alpha': 'prod',
             'texture_type': 'surface', 'anti_aliasing': False, 'fill_back': True}
    for k, v in fixed.items():
        if render.get(k, v) != v:
            raise ValueError(f'the SoftRas reference covers {k}={v!r} only')
    return Params(image_size=int(render['image_size']),
                  sigma_val=float(render.get('sigma_val', 1e-5)),
                  gamma_val=float(render.get('gamma_val', 1e-4)),
                  near=float(render.get('near', 1)), far=float(render.get('far', 100)),
                  eps=float(render.get('eps', 1e-3)),
                  dist_eps=float(render.get('dist_eps', 1e-4)),
                  background=tuple(float(c) for c in render.get('background_color', (0, 0, 0))),
                  K=int(render.get('max_faces_per_pixel_for_grad', 16)))


# --------------------------------------------------------------------------
# the pair math: a frozen copy of ops/softras/geometry.py
# --------------------------------------------------------------------------

def face_info(face):
    x0, y0 = face[..., 0], face[..., 1]
    x1, y1 = face[..., 3], face[..., 4]
    x2, y2 = face[..., 6], face[..., 7]
    inv_star = torch.stack([y1 - y2, x2 - x1, x1 * y2 - x2 * y1,
                            y2 - y0, x0 - x2, x2 * y0 - x0 * y2,
                            y0 - y1, x1 - x0, x0 * y1 - x1 * y0], dim=-1)
    det = x2 * (y0 - y1) + x0 * (y1 - y2) + x1 * (y2 - y0)
    det = torch.where(det > 0, det.clamp_min(1e-10), det.clamp_max(-1e-10))
    inv = inv_star / det[..., None]
    px = torch.stack([x0, x1, x2], dim=-1)
    py = torch.stack([y0, y1, y2], dim=-1)
    sym = (px[..., :, None] * px[..., None, :] + py[..., :, None] * py[..., None, :] + 1.0)
    sym = sym.reshape(sym.shape[:-2] + (9,))
    p = torch.stack([torch.stack([x0, y0], -1), torch.stack([x1, y1], -1),
                     torch.stack([x2, y2], -1)], dim=-2)
    obt = torch.stack([((p[..., (k + 1) % 3, :] - p[..., k, :]) *
                        (p[..., (k + 2) % 3, :] - p[..., k, :])).sum(-1) < 0
                       for k in range(3)], dim=-1)
    first = torch.cumsum(obt.to(torch.int32), dim=-1) <= 1
    return inv, sym, (obt & first).to(face.dtype)


def fma(a, b, c):
    """a * b + c rounded once (float32), as the kernels' fused multiply-add."""
    out = torch.promote_types(a.dtype, b.dtype)
    hi, c = a.double() * b.double(), c.double()
    s = hi + c
    if out == torch.float64:
        return s
    if out != torch.float32:
        return s.to(out)
    bb = s - hi
    err = (hi - (s - bb)) + (c - bb)
    away = torch.nextafter(s, torch.copysign(torch.full_like(s, torch.inf), err))
    return torch.where((err != 0) & (s.view(torch.int64) & 1 == 0), away, s).to(out)


def sum3(x):
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def dot3(a, b):
    return sum3(a * b)


def _safe_div(a, b, eps=1e-30):
    b = torch.where(b.abs() < eps, torch.where(b < 0, torch.full_like(b, -eps),
                                               torch.full_like(b, eps)), b)
    return a / b


def _edge_projection(w, sym, v0: int, clamp: bool):
    v1 = (v0 + 1) % 3
    sym = sym.reshape(sym.shape[:-1] + (3, 3))
    a0 = sym[..., v0, :] - sym[..., v1, :]
    t0 = _safe_div(dot3(w, a0) - a0[..., v1], a0[..., v0] - a0[..., v1])
    if clamp:
        t0 = t0.clamp(0.0, 1.0)
        t1 = (1.0 - t0).clamp(0.0, 1.0)
    else:
        t1 = 1.0 - t0
    comps = [None, None, None]
    comps[v0], comps[v1], comps[(v0 + 2) % 3] = t0, t1, torch.zeros_like(t0)
    return torch.stack(comps, dim=-1) - w


def euclidean(w, face, sym, obt, xp, yp):
    """(sign, dis_x, dis_y, t): the point-to-face distance's parts."""
    fx, fy = face[..., 0::3], face[..., 1::3]
    inside = ((w > 0) & (w < 1)).all(dim=-1)
    ts, diss, dxs, dys = [], [], [], []
    for k in range(3):
        t_k = _edge_projection(w, sym, k, clamp=False)
        dx, dy = dot3(t_k, fx), dot3(t_k, fy)
        ts.append(t_k)
        dxs.append(dx)
        dys.append(dy)
        diss.append(dx * dx + dy * dy)
    kmin = torch.stack(diss, -1).argmin(dim=-1)
    t_in = torch.gather(torch.stack(ts, -2), -2, kmin[..., None, None].expand(kmin.shape + (1, 3)))[..., 0, :]
    dx_in = torch.gather(torch.stack(dxs, -1), -1, kmin[..., None])[..., 0]
    dy_in = torch.gather(torch.stack(dys, -1), -1, kmin[..., None])[..., 0]

    w0n, w1n, w2n = w[..., 0] <= 0, w[..., 1] <= 0, w[..., 2] <= 0

    def corner_shift(base, other):
        bx, by, ox, oy = fx[..., base], fy[..., base], fx[..., other], fy[..., other]
        return (xp - bx) * (ox - bx) + (yp - by) * (oy - by) > 0

    c1 = w1n & w2n
    c2 = w2n & w0n & ~c1
    c3 = w0n & w1n & ~c1 & ~c2
    rest = ~(c1 | c2 | c3)
    e1 = rest & w0n
    e2 = rest & ~w0n & w1n
    e3 = rest & ~w0n & ~w1n & w2n

    def pick(cond, a, b):
        return torch.where(cond, torch.full_like(kmin, a), torch.full_like(kmin, b))

    v0 = torch.zeros_like(kmin)
    v0 = torch.where(c1, pick((obt[..., 0] == 1) & corner_shift(0, 2), 2, 0), v0)
    v0 = torch.where(c2, pick((obt[..., 1] == 1) & corner_shift(1, 0), 0, 1), v0)
    v0 = torch.where(c3, pick((obt[..., 2] == 1) & corner_shift(2, 1), 1, 2), v0)
    v0 = torch.where(e1, torch.ones_like(v0), v0)
    v0 = torch.where(e2, torch.full_like(v0, 2), v0)
    v0 = torch.where(e3, torch.zeros_like(v0), v0)
    t_opts = torch.stack([_edge_projection(w, sym, k, clamp=True) for k in range(3)], dim=-2)
    t_out = torch.gather(t_opts, -2, v0[..., None, None].expand(v0.shape + (1, 3)))[..., 0, :]
    sign = torch.where(inside, 1.0, -1.0).to(w.dtype)
    return (sign, torch.where(inside, dx_in, dot3(t_out, fx)),
            torch.where(inside, dy_in, dot3(t_out, fy)),
            torch.where(inside[..., None], t_in, t_out))


def texel_index(wc, R: int):
    w_x = (wc[..., 0] * R).clamp_max(float(R - 1)).to(torch.int64)
    w_y = (wc[..., 1] * R).clamp_max(float(R - 1)).to(torch.int64)
    low = (wc[..., 0] + wc[..., 1]) * R - w_x - w_y <= 1
    return torch.where(low, w_y * R + w_x, (R - 1 - w_y) * R + (R - 1 - w_x))


# --------------------------------------------------------------------------
# the pairs
# --------------------------------------------------------------------------

def pixel_boxes(face, p: Params):
    """Each face's pixels (r0, r1, c0, c1), their inflated bbox one pixel
    wider, clipped to the image; an empty box has r1 < r0 or c1 < c0."""
    is_ = p.image_size
    m = p.inflation
    xs, ys = face[..., 0::3].float(), face[..., 1::3].float()

    def idx(x):
        return torch.nan_to_num(x, nan=-2.0).clamp(-2, is_ + 1).to(torch.int64)

    c0 = idx(torch.floor(((xs.amin(-1) - m) * is_ + is_ - 1) / 2)).clamp_min(0)
    c1 = idx(torch.ceil(((xs.amax(-1) + m) * is_ + is_ - 1) / 2)).clamp_max(is_ - 1)
    r0 = idx(torch.floor((is_ - 1 - (ys.amax(-1) + m) * is_) / 2)).clamp_min(0)
    r1 = idx(torch.ceil((is_ - 1 - (ys.amin(-1) - m) * is_) / 2)).clamp_max(is_ - 1)
    return r0, r1, c0, c1


def pairs_of(face, p: Params):
    """(face ids, pixel ids) [P] of the listed pairs of one view's faces
    [F,9], face by face, each face's box row-major."""
    r0, r1, c0, c1 = pixel_boxes(face, p)
    h = (r1 - r0 + 1).clamp_min(0)
    w = (c1 - c0 + 1).clamp_min(0)
    n = h * w
    f = torch.repeat_interleave(torch.arange(n.numel(), device=face.device), n)
    k = torch.arange(f.numel(), device=face.device) - (n.cumsum(0) - n)[f]
    wf = w[f]
    return f, (r0[f] + k // wf) * p.image_size + c0[f] + k % wf


def pixel_centres(pix, is_: int, dtype):
    r = torch.div(pix, is_, rounding_mode='floor').to(torch.float32)
    c = (pix % is_).to(torch.float32)
    return ((2.0 * c + 1.0 - is_) / is_).to(dtype), ((is_ - 1.0 - 2.0 * r) / is_).to(dtype)


def pair_terms(face, inv, sym, obt, f, pix, p: Params):
    """Per pair: the forward's quantities (``torch_impl.pair_terms``)."""
    fb, xp, yp = face[f], *pixel_centres(pix, p.image_size, face.dtype)
    ib = inv[f].reshape(-1, 3, 3)
    w = fma(ib[..., 0], xp[:, None], ib[..., 1] * yp[:, None]) + ib[..., 2]
    xs, ys = fb[..., 0::3], fb[..., 1::3]
    m = p.inflation
    not_border = ~((xp > xs.amax(-1) + m) | (xp < xs.amin(-1) - m) |
                   (yp > ys.amax(-1) + m) | (yp < ys.amin(-1) - m))
    sign, dx, dy, t = euclidean(w, fb, sym[f], obt[f], xp, yp)
    dis = dx * dx + dy * dy
    dist_valid = ~((sign < 0) & (dis >= p.threshold))
    sf = torch.sigmoid(sign * dis / p.sigma_val)
    alpha_valid = not_border & dist_valid
    wc = w.clamp(0.0, 1.0)
    wc = wc / sum3(wc)[..., None].clamp_min(1e-5)
    zp = 1.0 / sum3(wc / fb[..., 2::3])
    tk_valid = alpha_valid & (zp >= p.near) & (zp <= p.far)
    inside = ((w <= 1) & (w >= 0)).all(dim=-1)
    return dict(w=w, wc=wc, sf=sf, zp=zp, alpha_valid=alpha_valid, tk_valid=tk_valid,
                t=t, sign=sign, dx=dx, dy=dy, not_border=not_border, inside=inside)


def _chunks(f, pix):
    for s in range(0, f.numel(), CHUNK_PAIRS):
        yield f[s:s + CHUNK_PAIRS], pix[s:s + CHUNK_PAIRS]


# --------------------------------------------------------------------------
# one view
# --------------------------------------------------------------------------

def forward_view(face, tex, p: Params, with_thr: bool):
    """face [F,9], tex [F,T,3] -> (image [4,HW], aggrs [2,HW], counts [HW],
    thr [HW] or None)."""
    dt, dev = face.dtype, face.device
    HW = p.image_size ** 2
    R = math.isqrt(tex.shape[1])
    inv, sym, obt = face_info(face)
    f_all, pix_all = pairs_of(face, p)
    M = torch.full((HW,), -math.inf, dtype=dt, device=dev)
    keep = torch.ones(HW, dtype=dt, device=dev)
    counts = torch.zeros(HW, dtype=torch.int64, device=dev)
    cand_f, cand_pix, cand_z = [], [], []
    for f, pix in _chunks(f_all, pix_all):
        t = pair_terms(face, inv, sym, obt, f, pix, p)
        zpn = (p.far - t['zp']) / (p.far - p.near)
        M.scatter_reduce_(0, pix, torch.where(t['tk_valid'], zpn, -math.inf), 'amax')
        keep.scatter_reduce_(0, pix, 1.0 - torch.where(t['alpha_valid'], t['sf'], 0.0), 'prod')
        counts.index_add_(0, pix, t['tk_valid'].long())
        if with_thr:
            c = t['tk_valid']
            cand_pix.append(pix[c])
            cand_z.append(t['zp'][c])
    M = M.clamp_min(p.eps)
    exp_bg = torch.exp((p.eps - M) / p.gamma_val)
    ssum = exp_bg.clone()
    num = exp_bg[:, None] * torch.tensor(p.background, dtype=dt, device=dev)[None, :]
    for f, pix in _chunks(f_all, pix_all):
        t = pair_terms(face, inv, sym, obt, f, pix, p)
        zpn = (p.far - t['zp']) / (p.far - p.near)
        coef = torch.where(t['tk_valid'], torch.exp((zpn - M[pix]) / p.gamma_val), 0.0) * t['sf']
        ssum.index_add_(0, pix, coef)
        num.index_add_(0, pix, coef[:, None] * tex[f, texel_index(t['wc'], R)])
    image = torch.cat([(num / ssum[:, None]).T, (1.0 - keep)[None]], 0)
    thr = None
    if with_thr:
        thr = kth_depth(torch.cat(cand_pix), torch.cat(cand_z), HW, p.K, p.far, dt)
    return image, torch.stack([ssum, M]), counts, thr


def kth_depth(pix, z, HW: int, K: int, far: float, dt):
    """The K-th smallest candidate depth of each pixel, ``far`` where it
    has at most K candidates."""
    order = torch.argsort(z, stable=True)
    order = order[torch.argsort(pix[order], stable=True)]
    pix, z = pix[order], z[order]
    n = torch.bincount(pix, minlength=HW)
    start = n.cumsum(0) - n
    rank = torch.arange(pix.numel(), device=pix.device) - start[pix]
    thr = torch.full((HW,), far, dtype=dt, device=z.device)
    at_k = rank == K - 1
    sel = pix[at_k]
    thr[sel] = torch.where(n[sel] > K, z[at_k], torch.tensor(far, dtype=dt, device=z.device))
    return thr


def backward_view(face, tex, image, aggrs, thr, grad, p: Params):
    """The top-K truncated gradient of one view: grad [4,HW] -> (grad_face
    [F,9], grad_tex [F,T,3])."""
    dt = face.dtype
    F, T = tex.shape[:2]
    R = math.isqrt(T)
    inv, sym, obt = face_info(face)
    gface = torch.zeros((F, 9), dtype=dt, device=face.device)
    gtex = torch.zeros((F * T, 3), dtype=dt, device=face.device)
    f_all, pix_all = pairs_of(face, p)
    for f, pix in _chunks(f_all, pix_all):
        t = pair_terms(face, inv, sym, obt, f, pix, p)
        zp, sf, wc = t['zp'], t['sf'], t['wc']
        valid = t['tk_valid'] & (zp <= thr[pix])
        g_rgb = grad[:3, pix].T
        g_alpha = grad[3, pix]
        c_xy = g_alpha * (1.0 - image[3, pix]) / (1.0 - sf).clamp_min(1e-6)
        zpn = (p.far - zp) / (p.far - p.near)
        e_arg = torch.where(valid, (zpn - aggrs[1, pix]) / p.gamma_val, -math.inf)
        zp_soft = sf * torch.exp(e_arg) / aggrs[0, pix]
        ti = f * T + texel_index(wc, R)
        c_rgb = ((tex.reshape(-1, 3)[ti] - image[:3, pix].T) * g_rgb).sum(-1) * zp_soft
        c_xy = c_xy + c_rgb / sf.clamp_min(1e-30)
        c_z = c_rgb / p.gamma_val / (p.near - p.far) * zp * zp
        zs = face[f][:, 2::3]
        gz = c_z[:, None] * wc / (zs * zs)
        gtex.index_add_(0, ti, torch.where(valid, zp_soft, 0.0)[:, None] * g_rgb)
        c_xy = c_xy * sf * (1.0 - sf) / p.sigma_val
        d = torch.stack([t['dx'], t['dy']], dim=-1)
        gxy = (2.0 * t['sign'] * c_xy)[:, None, None] * (t['t'] + t['w'])[:, :, None] * d[:, None, :]
        gv = torch.cat([gxy, gz[..., None]], -1)
        gface.index_add_(0, f, torch.where(valid[:, None, None], gv, 0.0).reshape(-1, 9))
    return gface, gtex.reshape(F, T, 3)


def census_view(face, p: Params):
    """The work one view's inputs need, counted from its pairs: pairs in
    the inflated bbox (the border test passes), inside the face, within the
    distance cut (candidates), within the top-K threshold, and the pixels
    with a candidate."""
    inv, sym, obt = face_info(face)
    f_all, pix_all = pairs_of(face, p)
    HW = p.image_size ** 2
    out = dict(in_bbox=0, inside=0, candidates=0)
    cand_pix, cand_z = [], []
    for f, pix in _chunks(f_all, pix_all):
        t = pair_terms(face, inv, sym, obt, f, pix, p)
        out['in_bbox'] += int(t['not_border'].sum())
        out['inside'] += int((t['not_border'] & t['inside']).sum())
        out['candidates'] += int(t['tk_valid'].sum())
        cand_pix.append(pix[t['tk_valid']])
        cand_z.append(t['zp'][t['tk_valid']])
    pix, z = torch.cat(cand_pix), torch.cat(cand_z)
    thr = kth_depth(pix, z, HW, p.K, p.far, face.dtype)
    out['within_thr'] = int((z <= thr[pix]).sum())
    out['drawn'] = int((torch.bincount(pix, minlength=HW) > 0).sum())
    return out


class SoftRasterize(torch.autograd.Function):
    """images [B,4,H,W] from face vertices [B,F,9] and textures [B,F,T,3];
    the backward is the top-K truncated one."""

    @staticmethod
    def forward(ctx, face, tex, p: Params):
        B = face.shape[0]
        outs = [forward_view(face[b], tex[b], p, ctx.needs_input_grad[0] or ctx.needs_input_grad[1])
                for b in range(B)]
        images = torch.stack([o[0] for o in outs])
        ctx.p = p
        ctx.save_for_backward(face, tex, images)
        ctx.aggrs = [o[1] for o in outs]
        ctx.thr = [o[3] for o in outs]
        return images.reshape(B, 4, p.image_size, p.image_size)

    @staticmethod
    def backward(ctx, grad):
        face, tex, images = ctx.saved_tensors
        B = face.shape[0]
        grad = grad.reshape(B, 4, -1)
        gf, gt = zip(*[backward_view(face[b], tex[b], images[b], ctx.aggrs[b], ctx.thr[b],
                                     grad[b], ctx.p) for b in range(B)])
        return torch.stack(gf), torch.stack(gt), None


def soft_rasterize(face_vertices, textures, p: Params):
    """[B,F,3,3] screen-space faces, [B,F,T,3] textures -> [B,4,H,W]."""
    B, F = face_vertices.shape[:2]
    R = math.isqrt(textures.shape[2])
    return SoftRasterize.apply(face_vertices.reshape(B, F, 9), textures[:, :, :R * R], p)


# the operations per pair of the least work, counted from the kernels'
# arithmetic (chip_smoke.py's OPS_* constants): an fma as two, exp and a
# division as one
OPS_DIST = 65      # a pair in the inflated bbox: barycentrics, inside tests,
#                    one clamped edge projection, the squared distance
OPS_INSIDE = 56    # inside the face: the other two edge projections
OPS_SHADE = 60     # a candidate: sigmoid, clip, depth, alpha, count, softmax, texel
OPS_LIST = 2       # a candidate against the pixel's K nearest so far
OPS_GRAD = 120     # a candidate within the threshold, backward


def least_work(census: dict, B: int, F: int, T: int, image_size: int, backward: bool):
    """(operations, bytes) that the rasterizer's work on these inputs
    needs at the least: the pairs' operations (the forward's distance test
    and shading, the threshold's compare and the backward's gradient where
    ``backward``), each input byte read once and each output byte written
    once."""
    ops = census['in_bbox'] * OPS_DIST + census['inside'] * OPS_INSIDE \
        + census['candidates'] * OPS_SHADE
    nbytes = 4 * B * F * (9 + 3 * T) + 4 * B * 4 * image_size ** 2
    if backward:
        ops += census['candidates'] * OPS_LIST + census['within_thr'] * OPS_GRAD
        nbytes += 4 * B * 4 * image_size ** 2 + 4 * B * F * (9 + 3 * T)
    return ops, nbytes
