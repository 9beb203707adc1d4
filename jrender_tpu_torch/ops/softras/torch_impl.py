"""SoftRas in plain PyTorch: the dense forward and backward over all faces.

Counterpart of ``jrender_tpu/ops/softras/jax_impl.py`` (``pixel_grid``,
``_pairwise_terms``, ``_sample_colors``, ``forward_single``,
``backward_single`` and their batched wrappers), which reproduces the
reference kernels (soft_rasterize.py:243-456 forward, :523-1358 backward).

These are the plain versions of the CUDA kernels (``cuda_impl``): the CPU
path of ``soft_rasterize`` and what each kernel is held against on the
card.  They evaluate every (pixel, face) pair, so they are chunked over
pixels to bound memory, and they take any list of pixel centres
``(xp, yp)``, so a subset of a full-size frame can be checked.  Float64
inputs stay float64.

Forward outputs per pixel: rgba, aggrs (softmax sum and max, or hard
depth and face index) and the candidate count (the reference's q_size:
pairs that pass the border, distance and depth tests).

The backward is the reference's top-K truncated one, not the derivative
of the forward.  A pixel sends gradient to its K nearest candidates
only.  The JAX oracle keeps their face ids (``topk_face_ids``, its third
forward output) and gathers them; the TPU kernels, and the CUDA kernels
here, keep one depth per pixel instead, the K-th smallest candidate
depth (``topk_threshold``), and mask with ``zp <= thr``.  The two agree
unless candidate depths tie at the K-th place: the oracle then keeps the
lower face index, the threshold keeps both.  ``backward_single`` takes
either.
"""
from __future__ import annotations

import math

import torch

from . import geometry as G
from .params import SoftRasParams

BIG_DEPTH = 10000000.0
# pairs evaluated at once by the chunked forward (bounds peak memory)
CHUNK_PAIRS = 1 << 21


def pixel_centers(rows, cols, image_size: int):
    """NDC centres of pixels (row 0 = top): the oracle's exact formulas
    xp = (2c + 1 - is) / is and yp = (is - 1 - 2r) / is in float32."""
    is_ = float(image_size)
    xp = (2.0 * cols.to(torch.float32) + 1.0 - is_) / is_
    yp = (is_ - 1.0 - 2.0 * rows.to(torch.float32)) / is_
    return xp, yp


def pixel_grid(image_size: int, device=None):
    """(xp, yp) of every pixel, flattened row-major [H*W]."""
    idx = torch.arange(image_size * image_size, device=device)
    return pixel_centers(idx // image_size, idx % image_size, image_size)


def _pairwise_terms(face, face_inv, face_sym, face_obt, xp, yp, p: SoftRasParams):
    """Per (pixel, face) forward quantities; face et al [F, ...], xp/yp [P].
    Returns a dict of [P, F] tensors."""
    return pair_terms(face[None], face_inv[None], face_sym[None], face_obt[None],
                      xp[:, None], yp[:, None], p)


def pair_terms(fb, face_inv, face_sym, face_obt, xpb, ypb, p: SoftRasParams):
    """``_pairwise_terms`` on operands that broadcast against each other:
    face rows [..., 9] (inv, sym [..., 9], obt [..., 3]) and pixel centres
    [...]; every term has the broadcast shape of the pairs."""
    w = G.barycentric_coordinate(face_inv, xpb, ypb)              # [...,3]
    threshold = p.threshold
    not_border = ~G.check_border_outside(xpb, ypb, fb,
                                         G.border_inflation(threshold))

    t = sign = dis_x = dis_y = None
    if p.dist_func_id == 0:
        inside = G.check_pixel_inside(w)
        sf = inside.to(fb.dtype)
        dist_valid = inside
    elif p.dist_func_id == 1:
        dis = G.barycentric_distance(w)
        dist_valid = ~(-dis >= threshold)
        sf = torch.sigmoid(dis / p.sigma_val)
    else:
        sign, dis_x, dis_y, t = G.euclidean_p2f_distance(
            w, fb, face_sym, face_obt, xpb, ypb)
        dis = dis_x * dis_x + dis_y * dis_y
        dist_valid = ~((sign < 0) & (dis >= threshold))
        sf = torch.sigmoid(sign * dis / p.sigma_val)

    alpha_valid = not_border & dist_valid
    w_clip = G.barycentric_clip(w)
    zp = G.perspective_depth(w_clip, fb)                          # [P,F]
    z_valid = (zp >= p.near) & (zp <= p.far)
    tk_valid = alpha_valid & z_valid
    return dict(w=w, w_clip=w_clip, sf=sf, zp=zp, alpha_valid=alpha_valid,
                tk_valid=tk_valid, t=t, sign=sign, dis_x=dis_x, dis_y=dis_y)


def _sample_colors(tex, w_clip, face, zp, p: SoftRasParams):
    """Per-pair colours [P,F,3], perspective-correct. tex: [F,T,3]."""
    if p.texture_type_id == 0:                                    # surface
        R = int(math.isqrt(tex.shape[1]))
        idx = G.sample_texture_surface_idx(w_clip, R)             # [P,F]
        fidx = torch.arange(tex.shape[0], device=tex.device)[None, :]
        return tex[fidx, idx]
    # vertex: tex [F,3,3] (per-corner rgb)
    wz = w_clip / face[..., 2::3]
    return torch.einsum('pfk,fkc->pfc', wz, tex) * zp[..., None]


def forward_single(face, tex, p: SoftRasParams, xp, yp, ids=None, n_faces=None):
    """Forward rasterization of one batch element over pixels (xp, yp) [P].

    face [F,9], tex [F,T,3] (surface) or [F,3,3] (vertex).  ``ids`` [F],
    where given, are the faces' own ids (the dir layout's faces come in
    Morton order): the hard z-buffer breaks depth ties by the lowest id and
    reports it, as it does by the lowest position without them.
    ``n_faces``, where given, is the mesh's face count, which alpha 'sum'
    divides by, when ``face`` is a part of it.
    Returns (soft_colors [P,4], aggrs [P,2], counts [P] int32).
    """
    F = face.shape[0]
    n_all = F if n_faces is None else n_faces
    face_inv, face_sym, face_obt = G.face_info_preprocess(face)
    terms = _pairwise_terms(face, face_inv, face_sym, face_obt, xp, yp, p)
    sf, zp = terms['sf'], terms['zp']
    alpha_valid, tk_valid = terms['alpha_valid'], terms['tk_valid']
    w_clip = terms['w_clip']
    bg = torch.tensor(p.background_color, dtype=face.dtype, device=face.device)

    # ---- alpha (soft_rasterize.py:349-358, 426-434) ----------------------
    sf_a = torch.where(alpha_valid, sf, 0.0)
    if p.alpha_func_id == 0:
        alpha = (alpha_valid & (sf > 0.5)).any(dim=1).to(face.dtype)
    elif p.alpha_func_id == 1:
        alpha = sf_a.sum(dim=1) / n_all
    else:
        alpha = 1.0 - (1.0 - sf_a).prod(dim=1)

    side_ok = G.check_face_frontside(face) | p.fill_back          # [F]

    # ---- rgb ------------------------------------------------------------
    if p.rgb_func_id == 1:  # softmax over depth (:399-419, 444-451)
        rgb_valid = tk_valid & side_ok[None, :]
        zpn = (p.far - zp) / (p.far - p.near)
        zpn_masked = torch.where(rgb_valid, zpn, -math.inf)
        M = zpn_masked.amax(dim=1).clamp_min(p.eps)               # [P]
        expz = torch.where(rgb_valid, torch.exp((zpn - M[:, None]) / p.gamma_val), 0.0)
        exp_bg = torch.exp((p.eps - M) / p.gamma_val)
        coef = expz * sf
        softmax_sum = exp_bg + coef.sum(dim=1)
        colors = _sample_colors(tex, w_clip, face[None], zp, p)
        num = exp_bg[:, None] * bg[None, :] + torch.einsum('pf,pfc->pc', coef, colors)
        rgb = num / softmax_sum[:, None]
        aggrs = torch.stack([softmax_sum, M], dim=1)
    elif p.rgb_func_id == 0:  # hard z-buffer (:390-397, 436-442)
        hard_valid = tk_valid & G.check_pixel_inside(terms['w']) & side_ok[None, :]
        zp_key = torch.where(hard_valid, zp, BIG_DEPTH)
        if ids is None:
            fmin = zp_key.argmin(dim=1)                           # first min wins
        else:
            # the lowest id among the nearest, wherever it stands
            tied = zp_key == zp_key.amin(dim=1, keepdim=True)
            idk = torch.where(tied, ids.long()[None, :], torch.iinfo(torch.int64).max)
            fmin = (idk == idk.amin(dim=1, keepdim=True)).to(torch.int8).argmax(dim=1)
        depth_min = zp_key.gather(1, fmin[:, None])[:, 0]
        has_hit = depth_min < BIG_DEPTH
        colors = _sample_colors(tex, w_clip, face[None], zp, p)
        hit_col = colors.gather(1, fmin[:, None, None].expand(-1, 1, 3))[:, 0]
        rgb = torch.where(has_hit[:, None], hit_col, bg[None, :])
        face_index_min = torch.where(has_hit, fmin if ids is None else ids.long()[fmin], -1)
        aggrs = torch.stack([torch.where(has_hit, depth_min, BIG_DEPTH),
                             face_index_min.to(face.dtype)], dim=1)
    else:
        rgb = bg[None, :].expand(xp.shape[0], 3)
        aggrs = torch.zeros((xp.shape[0], 2), dtype=face.dtype, device=face.device)

    counts = tk_valid.sum(dim=1, dtype=torch.int32)
    soft_colors = torch.cat([rgb, alpha[:, None]], dim=1)         # [P,4]
    return soft_colors, aggrs, counts


def _at(x, b):
    return None if x is None else x[b]


def forward_pixels(face_vertices, textures, p: SoftRasParams, xp, yp,
                   chunk_pairs: int = CHUNK_PAIRS, ids=None):
    """Chunked ``forward_single`` over a batch: face_vertices [B,F,9],
    textures [B,F,T,3] or [B,F,3,3], pixel centres [P]; ``ids`` [B,F] as
    ``forward_single`` takes them.
    Returns (colors [B,P,4], aggrs [B,P,2], counts [B,P])."""
    B, F = face_vertices.shape[:2]
    step = max(1, chunk_pairs // max(F, 1))
    outs = ([], [], [])
    for b in range(B):
        parts = [forward_single(face_vertices[b], textures[b], p,
                                xp[s:s + step], yp[s:s + step], _at(ids, b))
                 for s in range(0, xp.shape[0], step)]
        for o, part in zip(outs, zip(*parts)):
            o.append(torch.cat(part, dim=0))
    return tuple(torch.stack(o, dim=0) for o in outs)


def soft_rasterize_fwd_plain(face_vertices, textures, p: SoftRasParams,
                             chunk_pairs: int = CHUNK_PAIRS):
    """Full-image forward. face_vertices [B,F,9]; textures as above.

    Returns (images [B,4,H,W], aggrs [B,2,H,W], counts [B,H,W] int32).
    """
    B = face_vertices.shape[0]
    is_ = p.image_size
    xp, yp = pixel_grid(is_, face_vertices.device)
    col, ag, cnt = forward_pixels(face_vertices, textures, p, xp, yp, chunk_pairs)
    return (col.permute(0, 2, 1).reshape(B, 4, is_, is_),
            ag.permute(0, 2, 1).reshape(B, 2, is_, is_),
            cnt.reshape(B, is_, is_))


# --------------------------------------------------------------------------
# top-K: the threshold the kernels use and the face ids the JAX oracle uses
# --------------------------------------------------------------------------

def use_threshold(p: SoftRasParams, F: int) -> bool:
    """Whether the top-K truncation binds at all (pxt_impl.py:1066): with
    ``grad_mode='full'`` or K >= F every candidate sends gradient."""
    return p.grad_mode == 'topk' and p.max_faces_id < F


def _candidate_depths(face, p: SoftRasParams, xp, yp):
    """zp of every candidate pair, +inf elsewhere: [P, F]."""
    face_inv, face_sym, face_obt = G.face_info_preprocess(face)
    terms = _pairwise_terms(face, face_inv, face_sym, face_obt, xp, yp, p)
    return torch.where(terms['tk_valid'], terms['zp'], math.inf)


def _over_pixels(fn, B, xp, yp, step):
    """Stack fn(b, xp chunk, yp chunk) over pixel chunks and the batch."""
    return torch.stack([
        torch.cat([fn(b, xp[s:s + step], yp[s:s + step])
                   for s in range(0, xp.shape[0], step)], dim=0)
        for b in range(B)], dim=0)


def topk_threshold(face_vertices, p: SoftRasParams, xp, yp,
                   chunk_pairs: int = CHUNK_PAIRS):
    """The K-th smallest candidate depth of each pixel, K = p.max_faces_id,
    and ``far`` where the pixel has at most K candidates: the plain version
    of the threshold kernel (the TPU kernel's ``with_thr`` output,
    pxt_impl.py:584-674).  face_vertices [B,F,9], pixel centres [P];
    returns [B,P]."""
    B, F = face_vertices.shape[:2]
    K = p.max_faces_id

    def one(b, x, y):
        if K >= F:
            return torch.full_like(x, p.far, dtype=face_vertices.dtype)
        key = _candidate_depths(face_vertices[b], p, x, y)
        kth = torch.kthvalue(key, K, dim=1).values
        return torch.where(torch.isfinite(key).sum(dim=1) > K, kth, p.far)

    return _over_pixels(one, B, xp, yp, max(1, chunk_pairs // max(F, 1)))


def topk_face_ids(face_vertices, p: SoftRasParams, xp, yp,
                  chunk_pairs: int = CHUNK_PAIRS):
    """Face ids of each pixel's K nearest candidates, nearest first, -1
    padded; the lowest index wins ties (a stable sort): the JAX oracle's
    third forward output (jax_impl.py:176-186).  Returns [B,P,K] int64."""
    B, F = face_vertices.shape[:2]
    K = p.max_faces_id

    def one(b, x, y):
        key = _candidate_depths(face_vertices[b], p, x, y)
        if F < K:  # pad so that there are always K slots
            key = torch.nn.functional.pad(key, (0, K - F), value=math.inf)
        vals, order = torch.sort(key, dim=1, stable=True)
        return torch.where(torch.isfinite(vals[:, :K]), order[:, :K], -1)

    return _over_pixels(one, B, xp, yp, max(1, chunk_pairs // max(F, 1)))


# --------------------------------------------------------------------------
# backward
# --------------------------------------------------------------------------

def backward_single(face, tex, colors, aggrs, grad_out, p: SoftRasParams, xp, yp,
                    thr=None, face_ids=None, ids=None, n_faces=None):
    """Backward of one batch element over pixels (xp, yp) [P], dense over
    all faces (``backward_single`` of the JAX oracle, jax_impl.py:189-331,
    in the masked form of the TPU kernel, pxt_impl.py:900-1038).

    face [F,9], tex [F,T,3] or [F,3,3], colors/grad_out [P,4], aggrs [P,2].
    A candidate pair sends gradient when ``zp <= thr`` (thr [P], as the
    kernels mask), or when its face is among ``face_ids`` [P,K] (as the
    oracle gathers), or always when both are None.
    ``ids`` [F], where given, are the faces' own ids, which the hard-rgb
    winner in ``aggrs`` names; ``n_faces``, where given, is the mesh's face
    count, which alpha 'sum' divides by, when ``face`` is a part of it.
    Returns (grad_face [F,9], grad_tex like tex).
    """
    F = face.shape[0]
    n_all = F if n_faces is None else n_faces
    dt = face.dtype
    face_inv, face_sym, face_obt = G.face_info_preprocess(face)
    terms = _pairwise_terms(face, face_inv, face_sym, face_obt, xp, yp, p)
    w, wc, zp = terms['w'], terms['w_clip'], terms['zp']
    valid = terms['tk_valid']
    if thr is not None:
        valid = valid & (zp <= thr[:, None])
    if face_ids is not None:
        fidx = torch.arange(F, device=face.device)
        valid = valid & (face_ids[:, :, None] == fidx[None, None, :]).any(dim=1)
    # dist hard: sf = 1 in the backward, so the xy chain vanishes
    sf = torch.ones_like(zp) if p.dist_func_id == 0 else terms['sf']

    def masked(x):
        return torch.where(valid, x, 0.0)

    g_rgb = grad_out[:, :3]                                       # [P,3]
    g_alpha = grad_out[:, 3:4]                                    # [P,1]
    if p.alpha_func_id == 0:
        C_grad_xy = torch.zeros_like(sf)
    elif p.alpha_func_id == 1:
        C_grad_xy = (g_alpha / n_all).expand_as(sf)
    else:
        C_grad_xy = g_alpha * (1.0 - colors[:, 3:4]) / (1.0 - sf).clamp_min(1e-6)

    zs = face[None, :, 2::3]                                      # [1,F,3]
    gz = None
    grad_tex = torch.zeros_like(tex)
    surface = p.texture_type_id == 0
    if surface:
        T = tex.shape[1]
        idx = G.sample_texture_surface_idx(wc, int(math.isqrt(T)))  # [P,F]

    def texture_grad(coef):
        """Sum coef [P,F] * g_rgb over the pixels into the texels."""
        coef = masked(coef)
        if surface:
            # one product per texel: a sum over pixels in a fixed order
            return torch.stack([torch.where(idx == ti, coef, 0.0).T @ g_rgb
                                for ti in range(T)], dim=1)       # [F,T,3]
        # vertex: corner k takes coef * wc_k * g
        return torch.einsum('pf,pfk,pc->fkc', coef, wc, g_rgb)

    if p.rgb_func_id == 1:
        softmax_sum = aggrs[:, 0:1]
        softmax_max = aggrs[:, 1:2]
        zpn = (p.far - zp) / (p.far - p.near)
        e_arg = torch.where(valid, (zpn - softmax_max) / p.gamma_val, -math.inf)
        zp_softmax = sf * torch.exp(e_arg) / softmax_sum
        # colour WITHOUT perspective correction, and with no front-side
        # check (reference backward, soft_rasterize.py:1136-1151)
        if surface:
            farange = torch.arange(F, device=face.device)[None, :]
            colors_nc = tex[farange, idx]                         # [P,F,3]
        else:
            colors_nc = torch.einsum('pfk,fkc->pfc', wc, tex)
        C_rgb = ((colors_nc - colors[:, None, :3]) * g_rgb[:, None, :]).sum(-1) * zp_softmax
        C_grad_xy = C_grad_xy + C_rgb / sf.clamp_min(1e-30)
        C_grad_z = C_rgb / p.gamma_val / (p.near - p.far) * zp * zp
        gz = C_grad_z[..., None] * wc / (zs * zs)                 # [P,F,3]
        grad_tex = texture_grad(zp_softmax)
    elif p.rgb_func_id == 0:
        # hard rgb: the texture gradient goes to the winning face only
        win = aggrs[:, 1].to(torch.int64)[:, None]
        own = torch.arange(F, device=face.device) if ids is None else ids.long()
        is_win = own[None, :] == win
        grad_tex = texture_grad(is_win.to(dt))

    # ---- sigmoid chain to the vertex xy (soft_rasterize.py:1336-1347) ----
    C_grad_xy = C_grad_xy * sf * (1.0 - sf) / p.sigma_val
    gxy = None
    if p.dist_func_id == 1:
        # the barycentric chain reads the *unclipped* w (:1118-1132)
        pmin = torch.where(w[..., 0] > w[..., 1],
                           torch.where(w[..., 1] > w[..., 2], 2, 1),
                           torch.where(w[..., 0] > w[..., 2], 2, 0))  # [P,F]
        inv = face_inv.reshape(F, 3, 3)[None].expand(pmin.shape + (3, 3))
        inv_p = torch.gather(inv, -2, pmin[..., None, None].expand(pmin.shape + (1, 3)))[..., 0, :2]
        scale = 2.0 * torch.sqrt(G.barycentric_distance(w).abs())
        gxy = -inv_p[..., None, :] * w[..., :, None] * (C_grad_xy * scale)[..., None, None]
    elif p.dist_func_id == 2:
        d = torch.stack([terms['dis_x'], terms['dis_y']], dim=-1)  # [P,F,2]
        tau = terms['t'] + w                                      # the projection
        gxy = (2.0 * terms['sign'] * C_grad_xy)[..., None, None] * tau[..., :, None] * d[..., None, :]

    grad_v = torch.zeros(zp.shape + (3, 3), dtype=dt, device=face.device)
    if gxy is not None:
        grad_v[..., :2] = gxy
    if gz is not None:
        grad_v[..., 2] = gz
    grad_face = torch.where(valid[..., None, None], grad_v, 0.0).sum(dim=0)
    return grad_face.reshape(F, 9), grad_tex


def backward_pixels(face_vertices, textures, colors, aggrs, grad_out,
                    p: SoftRasParams, xp, yp, thr=None, face_ids=None,
                    chunk_pairs: int = CHUNK_PAIRS // 4, ids=None):
    """Chunked ``backward_single`` over a batch: the gradient of the pixels
    (xp, yp) [P] alone.  colors/grad_out [B,P,4], aggrs [B,P,2], thr [B,P]
    or face_ids [B,P,K] or neither; ``ids`` [B,F] as ``backward_single``
    takes them.  Returns (grad_face_vertices [B,F,9],
    grad_textures like textures)."""
    B, F = face_vertices.shape[:2]
    step = max(1, chunk_pairs // max(F, 1))
    gf = torch.zeros_like(face_vertices)
    gt = torch.zeros_like(textures)
    for b in range(B):
        for s in range(0, xp.shape[0], step):
            e = s + step
            f, t = backward_single(
                face_vertices[b], textures[b], colors[b, s:e], aggrs[b, s:e],
                grad_out[b, s:e], p, xp[s:e], yp[s:e],
                None if thr is None else thr[b, s:e],
                None if face_ids is None else face_ids[b, s:e], _at(ids, b))
            gf[b] += f
            gt[b] += t
    return gf, gt


def topk_threshold_plain(face_vertices, p: SoftRasParams,
                         chunk_pairs: int = CHUNK_PAIRS):
    """Full-image threshold map [B,H,W] (see ``topk_threshold``)."""
    is_ = p.image_size
    xp, yp = pixel_grid(is_, face_vertices.device)
    thr = topk_threshold(face_vertices, p, xp, yp, chunk_pairs)
    return thr.reshape(face_vertices.shape[0], is_, is_)


def soft_rasterize_bwd_plain(face_vertices, textures, images, aggrs, thr,
                             grad_images, p: SoftRasParams, **kw):
    """Full-image backward.  images/grad_images [B,4,H,W], aggrs [B,2,H,W],
    thr [B,H,W] or None (no truncation).  Returns (grad_face_vertices
    [B,F,9], grad_textures like textures)."""
    B = face_vertices.shape[0]
    xp, yp = pixel_grid(p.image_size, face_vertices.device)

    def flat(x):
        return x.reshape(B, x.shape[1], -1).permute(0, 2, 1)

    return backward_pixels(face_vertices, textures, flat(images), flat(aggrs),
                           flat(grad_images), p, xp, yp,
                           None if thr is None else thr.reshape(B, -1), **kw)
