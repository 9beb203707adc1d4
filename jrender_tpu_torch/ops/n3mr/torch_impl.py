"""N3MR (Neural 3D Mesh Renderer, Kato 2018) in plain PyTorch.

Counterpart of ``jrender_tpu/ops/n3mr/impl.py``, batched: every function
takes the batch dimension that the JAX package maps over.  These are the
plain versions that the CUDA kernels of ``csrc/n3mr_*.cu`` are held
against, and what a CPU tensor runs.  float32 by default; float64 inputs
stay float64.

  * ``forward_maps``: the z-buffer.  Per pixel the nearest front face
    that passes the strict inside test with near < depth < far; the
    lowest face id wins exact depth ties.
  * ``trilinear_rgb_from_maps``: the trilinear fetch from the winner's
    [ts,ts,ts] texture volume, as a tent-weight contraction.
  * ``backward_textures``: the texture gradient, summed per winner face.
  * ``backward_depth``: the analytic depth gradient.
  * ``backward_pixel_map``: the NMR edge gradient as a plane sweep: every
    (face, d0, d1) cell of every (edge, axis) case in one masked grid.
    It is the independent oracle of the edge-gradient kernel, which walks
    each edge instead.

Images are in the rasterizer's own orientation (row index grows with y);
``api.rasterize_rgbad`` flips them.

The arithmetic of everything that feeds a comparison (the inside test,
the barycentric weights, the depth, the edge crossings) is written one
operation at a time in a fixed order, which the kernels repeat with
round-to-nearest intrinsics, so that both sides take the same side of
every discontinuity.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..segment_sum import segment_order, segment_sum

ROW = 19          # per-face row: face 9, pixel-space inverse 9, front 1
ROW_INV = 9
ROW_FRONT = 18


class N3mrMaps(NamedTuple):
    """The forward's maps, kept for the backward."""
    face_index: torch.Tensor    # [B,H,W] int32, -1 empty
    weight: torch.Tensor        # [B,H,W,3]
    depth: torch.Tensor         # [B,H,W], far where empty
    face_inv: torch.Tensor      # [B,H,W,9], 0 where empty
    zcorn: torch.Tensor         # [B,H,W,3] winner's corner depths, 1 where empty
    rgb: torch.Tensor           # [B,H,W,3]
    alpha: torch.Tensor         # [B,H,W]


def _face_frontside_n3mr(face):
    """n3mr draws the faces for which the reference kernel does not return
    early (rasterize.py:63): the opposite winding to SoftRas' front."""
    return ~((face[..., 7] - face[..., 1]) * (face[..., 3] - face[..., 0]) <
             (face[..., 4] - face[..., 1]) * (face[..., 6] - face[..., 0]))


def _pixel_space(v, is_):
    """p = 0.5 * (v * is + is - 1) for x and y (rasterize.py:68-72)."""
    return 0.5 * (v * is_ + is_ - 1)


def _face_inv_pixel(face, is_):
    """Pixel-space inverse barycentric matrix [..., 9], row k the weights
    of corner k (rasterize.py:75-87).  No determinant clamp: the reference
    divides directly, so a zero-area face gives inf or NaN."""
    px = _pixel_space(face[..., 0::3], is_)
    py = _pixel_space(face[..., 1::3], is_)
    x0, x1, x2 = px[..., 0], px[..., 1], px[..., 2]
    y0, y1, y2 = py[..., 0], py[..., 1], py[..., 2]
    inv = torch.stack([
        y1 - y2, x2 - x1, x1 * y2 - x2 * y1,
        y2 - y0, x0 - x2, x2 * y0 - x0 * y2,
        y0 - y1, x1 - x0, x0 * y1 - x1 * y0,
    ], -1)
    det = x2 * (y0 - y1) + x0 * (y1 - y2) + x1 * (y2 - y0)
    return inv / det[..., None]


def face_rows(face, is_):
    """[B, F, 19] rows that the z-buffer reads, kernel and plain version
    alike: face 9, pixel-space inverse 9, front 1.  A zero-area face has a
    non-finite inverse; it is zeroed, which turns the face's depth into
    NaN at every pixel, so the face is rejected (as the JAX package's
    kernel path does, pallas_impl.py:194-198)."""
    inv = _face_inv_pixel(face, is_)
    inv = torch.where(torch.isfinite(inv), inv, 0.0)
    front = _face_frontside_n3mr(face).to(face.dtype)[..., None]
    return torch.cat([face, inv, front], dim=-1).contiguous()


def _pixel_coords(pixels, is_, dtype):
    """(XI, YI, xp, yp) of flat pixel indices: integer pixel coordinates
    and the NDC pixel centres (2c + 1 - is) / is; y grows with the row."""
    XI = (pixels % is_).to(dtype)
    YI = torch.div(pixels, is_, rounding_mode='floor').to(dtype)
    xp = (2.0 * XI + 1 - is_) / is_
    yp = (2.0 * YI + 1 - is_) / is_
    return XI, YI, xp, yp


def _pair_terms(r, XI, YI, xp, yp):
    """One (pixel, face) pair per broadcast element: r [..., 19] rows
    against pixel coordinates.  Returns (inside & front, normalised
    clipped barycentrics w0, w1, w2, depth zp) (rasterize.py:113-133)."""
    x0, y0, z0 = r[..., 0], r[..., 1], r[..., 2]
    x1, y1, z1 = r[..., 3], r[..., 4], r[..., 5]
    x2, y2, z2 = r[..., 6], r[..., 7], r[..., 8]
    # strict inside test in NDC
    e0 = (yp - y0) * (x1 - x0) < (xp - x0) * (y1 - y0)
    e1 = (yp - y1) * (x2 - x1) < (xp - x1) * (y2 - y1)
    e2 = (yp - y2) * (x0 - x2) < (xp - x2) * (y0 - y2)
    inside = ~(e0 | e1 | e2) & (r[..., ROW_FRONT] > 0.5)
    # barycentrics at integer pixel coordinates
    w = [(r[..., ROW_INV + 3 * k] * XI + r[..., ROW_INV + 3 * k + 1] * YI
          + r[..., ROW_INV + 3 * k + 2]).clamp(0.0, 1.0) for k in range(3)]
    wsum = w[0] + w[1] + w[2]
    w = [wk / wsum for wk in w]
    zp = 1.0 / (w[0] / z0 + w[1] / z1 + w[2] / z2)
    return inside, w, zp


def forward_maps(face, is_, near, far, face_chunk=512, pixels=None):
    """The z-buffer.  face: [B, F, 9] NDC.  Returns (face_index [B,H,W]
    int32, weight [B,H,W,3], depth [B,H,W], face_inv [B,H,W,9], zcorn
    [B,H,W,3]).  With ``pixels`` (flat indices r * is + c, [P]) only those
    pixels are computed and the maps are [B,P,...].  Chunked over faces
    and pixels, so memory stays bounded."""
    B, F = face.shape[:2]
    dev, dt = face.device, face.dtype
    rows = face_rows(face, is_)
    whole = pixels is None
    if whole:
        pixels = torch.arange(is_ * is_, device=dev)
    P = pixels.numel()
    XI, YI, xp, yp = _pixel_coords(pixels, is_, dt)
    pblk = max(256, min(P, (1 << 22) // face_chunk))
    best_z = torch.empty((B, P), dtype=dt, device=dev)
    best_f = torch.empty((B, P), dtype=torch.int64, device=dev)
    for p0 in range(0, P, pblk):
        sl = slice(p0, p0 + pblk)
        c = [a[None, sl, None] for a in (XI, YI, xp, yp)]
        n = c[0].shape[1]
        bz = torch.full((B, n), float('inf'), dtype=dt, device=dev)
        bf = torch.full((B, n), -1, dtype=torch.int64, device=dev)
        for f0 in range(0, F, face_chunk):
            r = rows[:, None, f0:f0 + face_chunk]                   # [B,1,C,19]
            inside, _, zp = _pair_terms(r, *c)
            ok = inside & (zp > near) & (zp < far)
            zkey = torch.where(ok, zp, float('inf'))
            zmin = zkey.amin(dim=-1)
            # the lowest face id among the chunk's depth ties; earlier
            # chunks (lower ids) keep theirs through the strict <
            ids = torch.arange(f0, f0 + r.shape[2], device=dev)
            idmin = torch.where(zkey == zmin[..., None], ids, F).amin(dim=-1)
            upd = zmin < bz
            bf = torch.where(upd, idmin, bf)
            bz = torch.where(upd, zmin, bz)
        best_z[:, sl] = bz
        best_f[:, sl] = bf

    has = best_f >= 0
    b = torch.arange(B, device=dev)[:, None]
    rw = rows[b, best_f.clamp_min(0)]                               # [B,P,19]
    _, w, _ = _pair_terms(rw, XI[None], YI[None], xp[None], yp[None])
    hm = has[..., None]
    weight = torch.where(hm, torch.stack(w, -1), 0.0)
    depth = torch.where(has, best_z, float(far))
    face_inv = torch.where(hm, rw[..., ROW_INV:ROW_INV + 9], 0.0)
    zcorn = torch.where(hm, rw[..., 2:9:3], 1.0)
    face_index = torch.where(has, best_f, -1).to(torch.int32)
    if whole:
        return (face_index.reshape(B, is_, is_), weight.reshape(B, is_, is_, 3),
                depth.reshape(B, is_, is_), face_inv.reshape(B, is_, is_, 9),
                zcorn.reshape(B, is_, is_, 3))
    return face_index, weight, depth, face_inv, zcorn


def sampling_tif(weight, depth, zcorn, ts, eps):
    """Texture-volume coordinates [..., 3] of a pixel (rasterize.py:252-257)."""
    tif = weight * (ts - 1) * (depth[..., None] / zcorn)
    return tif.clamp(0.0, ts - 1 - eps)


def tent_weights(tif, ts):
    """Per-axis tent weights, 3 x [..., ts]: w_i = max(0, 1 - |tif_a - i|).
    The same as the reference's 8 trilinear taps (rasterize.py:259-298):
    1 - frac lands on floor(tif), frac on floor(tif) + 1, zero elsewhere."""
    grid = torch.arange(ts, dtype=tif.dtype, device=tif.device)
    return [(1.0 - (tif[..., a:a + 1] - grid).abs()).clamp_min(0.0) for a in range(3)]


def trilinear_rgb_from_maps(textures, face_index, weight, depth, zcorn, eps,
                            pixel_chunk=1 << 18):
    """Texture fetch from the z-buffer's maps.  textures: [B,F,ts,ts,ts,3];
    maps [B,...] with any pixel dimensions.  Returns rgb [B,...,3], 0
    where no face was drawn."""
    B, F, ts = textures.shape[:3]
    lead = face_index.shape
    texf = textures.reshape(B, F, -1)
    fi = face_index.reshape(B, -1).long()
    wt, dp, zc = weight.reshape(B, -1, 3), depth.reshape(B, -1), zcorn.reshape(B, -1, 3)
    P = fi.shape[1]
    b = torch.arange(B, device=fi.device)[:, None]
    out = torch.empty((B, P, 3), dtype=textures.dtype, device=textures.device)
    for p0 in range(0, P, pixel_chunk):
        sl = slice(p0, p0 + pixel_chunk)
        has = fi[:, sl] >= 0
        texrow = texf[b, fi[:, sl].clamp_min(0)]                    # [B,n,ts^3*3]
        if ts == 1:
            rgb = texrow
        else:
            tw = tent_weights(sampling_tif(wt[:, sl], dp[:, sl], zc[:, sl], ts, eps), ts)
            c1, c2 = ts * ts * 3, ts * 3
            t1 = sum(tw[0][..., i:i + 1] * texrow[..., i * c1:(i + 1) * c1] for i in range(ts))
            t2 = sum(tw[1][..., j:j + 1] * t1[..., j * c2:(j + 1) * c2] for j in range(ts))
            rgb = sum(tw[2][..., k:k + 1] * t2[..., k * 3:(k + 1) * 3] for k in range(ts))
        out[:, sl] = torch.where(has[..., None], rgb, 0.0)
    return out.reshape(*lead, 3)


def texture_grad_rows(face_index, weight, depth, zcorn, grad_rgb, ts, eps):
    """The per-pixel rows that the texture gradient sums per winner face:
    [N, ts^3 * 3], the tent-weight outer product times the pixel's rgb
    gradient, 0 where no face was drawn.  Maps flattened to N pixels."""
    has = face_index.reshape(-1) >= 0
    g = grad_rgb.reshape(-1, 3)
    if ts == 1:
        rows = g
    else:
        tw = tent_weights(sampling_tif(weight.reshape(-1, 3), depth.reshape(-1),
                                       zcorn.reshape(-1, 3), ts, eps), ts)
        w01 = tw[0][:, :, None] * tw[1][:, None, :]                 # [N,ts,ts]
        w012 = w01[..., None] * tw[2][:, None, None, :]             # [N,ts,ts,ts]
        rows = (w012[..., None] * g[:, None, None, None, :]).reshape(g.shape[0], -1)
    return torch.where(has[:, None], rows, 0.0)


def backward_textures(tex_shape, face_index, weight, depth, zcorn, grad_rgb, eps,
                      pixel_chunk=1 << 18):
    """Texture gradient [B,F,ts,ts,ts,3] (rasterize.py:660-694): each
    pixel's row added to its winner face.  ``tex_shape`` is the textures'
    shape.  The sum is ``index_add_``: on a card its order, and so the
    last bits, can change from run to run (the kernel's does not)."""
    B, F, ts = tex_shape[:3]
    fi = face_index.reshape(-1).long()
    N = fi.numel()
    per_b = N // B
    seg = torch.where(fi >= 0, fi + torch.arange(B, device=fi.device)
                      .repeat_interleave(per_b) * F, B * F)
    out = torch.zeros((B * F + 1, ts ** 3 * 3), dtype=grad_rgb.dtype, device=grad_rgb.device)
    wt, dp = weight.reshape(-1, 3), depth.reshape(-1)
    zc, g = zcorn.reshape(-1, 3), grad_rgb.reshape(-1, 3)
    for p0 in range(0, N, pixel_chunk):
        sl = slice(p0, p0 + pixel_chunk)
        out.index_add_(0, seg[sl], texture_grad_rows(fi[sl], wt[sl], dp[sl], zc[sl],
                                                     g[sl], ts, eps))
    return out[:-1].reshape(B, F, ts, ts, ts, 3)


def backward_depth(face, face_index, face_inv, weight, depth, zcorn, grad_depth):
    """Analytic depth gradient [B,F,9] (rasterize.py:729-788), from the
    per-pixel maps alone.  The sum per face is ``ops.segment_sum``: each
    face adds its pixels in ascending order, with no float atomics on the
    card, so two runs give the same bits."""
    B, F = face.shape[:2]
    is_ = face_index.shape[1]
    fi = face_index.reshape(B, -1).long()
    has = fi >= 0
    inv = face_inv.reshape(B, -1, 3, 3)
    wt = weight.reshape(B, -1, 3)
    dp = depth.reshape(B, -1)
    gd = torch.where(has, grad_depth.reshape(B, -1), 0.0)
    d2 = dp * dp
    zs = zcorn.reshape(B, -1, 3)
    gz = gd[..., None] * wt * d2[..., None] / (zs * zs)              # [B,P,3]
    tmp = -(inv / zs[..., None]).sum(dim=2)                          # [B,P,3]
    gxy = -gd[..., None, None] * tmp[:, :, None, :2] * wt[..., None] \
        * d2[..., None, None] * is_ / 2.0                            # [B,P,3,2]
    gv = torch.cat([gxy, gz[..., None]], -1)                         # [B,P,3,3]
    gv = torch.where(has[..., None, None], gv, 0.0).reshape(-1, 9)
    seg = torch.where(has, fi + torch.arange(B, device=fi.device)[:, None] * F, B * F)
    out = segment_sum(gv, segment_order(seg, B * F))
    return out.reshape(B, F, 9)


class _EdgeRows(NamedTuple):
    """One (edge, axis) case of a chunk of faces, per d0 row: [Fc, is]
    unless noted."""
    pi: list                   # the edge's corners: pi[0] -> pi[1], pi[2] opposite
    p00: torch.Tensor          # [Fc] corner coordinates: p<corner><d0 or d1>
    p10: torch.Tensor
    d1_cross: torch.Tensor     # where the edge crosses the row
    idx_in: torch.Tensor       # flat pixel index of the crossing pixel inside
    idx_out: torch.Tensor      # ... and of its neighbour outside
    out_ok: torch.Tensor       # the OUT scan runs: the crossing pixel is the face's own
    lo_out: torch.Tensor       # its d1 range
    hi_out: torch.Tensor
    in_ok: torch.Tensor        # the IN scan runs
    lo_in: torch.Tensor        # its d1 range (own pixels only)
    hi_in: torch.Tensor


def _edge_rows(pp, front, fids, fi_flat, is_, edge_num, axis) -> _EdgeRows:
    """The predicates of one (edge, axis) case (banded_bwd.py:194-253):
    which d0 rows the edge spans, where it crosses each, and the d1 ranges
    of the two scans.  pp [Fc,3,2] pixel-space xy, front [Fc], fids [Fc]."""
    dev, dt = pp.device, pp.dtype
    d0v = torch.arange(is_, dtype=dt, device=dev)
    d0i = torch.arange(is_, device=dev)[None]                        # [1,is]
    pi = [(edge_num + n) % 3 for n in range(3)]
    p00, p01 = pp[:, pi[0], axis], pp[:, pi[0], 1 - axis]
    p10, p11 = pp[:, pi[1], axis], pp[:, pi[1], 1 - axis]
    p20, p21 = pp[:, pi[2], axis], pp[:, pi[2], 1 - axis]
    sgn = 1.0 if axis == 0 else -1.0
    direction = torch.where(p00 < p10, -1.0, 1.0).to(dt) * sgn

    d0_from = torch.minimum(p00, p10).ceil().clamp_min(0.0)
    d0_to = torch.maximum(p00, p10).clamp_max(is_ - 1.0)
    d0_ok = (d0v >= d0_from[:, None]) & (d0v <= d0_to[:, None]) & front[:, None]

    slope = (p11 - p01) / (p10 - p00)
    d1_cross = slope[:, None] * (d0v - p00[:, None]) + p01[:, None]
    up = direction[:, None] > 0
    d1_in_f = torch.where(up, d1_cross.floor(), d1_cross.ceil())
    d1_out_f = d1_in_f + direction[:, None]
    # float compares before the int cast: NaN and inf fail them
    bd_ok = d0_ok & (d1_in_f >= 0) & (d1_in_f <= is_ - 1) & \
        (d1_out_f >= 0) & (d1_out_f <= is_ - 1)
    d1_in = torch.nan_to_num(d1_in_f).clamp(0, is_ - 1).long()
    d1_out = torch.nan_to_num(d1_out_f).clamp(0, is_ - 1).long()
    if axis == 0:
        idx_in, idx_out = d1_in * is_ + d0i, d1_out * is_ + d0i
    else:
        idx_in, idx_out = d0i * is_ + d1_in, d0i * is_ + d1_out

    # OUT: from the crossing to the screen border, where the crossing
    # pixel is the face's own
    lim_out = torch.where(direction > 0, is_ - 1, 0)[:, None]
    # IN: from the crossing to the opposite edge's crossing
    between = (d0v - p00[:, None]) * (d0v - p20[:, None]) < 0
    cross_a = ((p21 - p01) / (p20 - p00))[:, None] * (d0v - p00[:, None]) + p01[:, None]
    cross_b = ((p11 - p21) / (p10 - p20))[:, None] * (d0v - p20[:, None]) + p21[:, None]
    cross2 = torch.where(between, cross_a, cross_b)
    lim_in_f = torch.where(up, cross2.ceil(), cross2.floor())
    lim_in = torch.nan_to_num(lim_in_f).clamp(-1, is_).long()
    return _EdgeRows(
        pi=pi, p00=p00, p10=p10, d1_cross=d1_cross, idx_in=idx_in, idx_out=idx_out,
        out_ok=bd_ok & (fi_flat[idx_in] == fids[:, None]),
        lo_out=torch.minimum(d1_out, lim_out).clamp_min(0),
        hi_out=torch.maximum(d1_out, lim_out).clamp_max(is_ - 1),
        in_ok=bd_ok & torch.isfinite(lim_in_f),
        lo_in=torch.minimum(d1_in, lim_in).clamp_min(0),
        hi_in=torch.maximum(d1_in, lim_in).clamp_max(is_ - 1))


def _edge_grads(pp, front, fids, fi_map, alpha_map, ga_map, rgb_map, gr_map,
                is_, eps, return_rgb, return_alpha):
    """Edge gradients [Fc, 3, 3] of a chunk of faces of one batch element:
    pp [Fc,3,2] pixel-space xy, front [Fc], fids [Fc] the faces' ids."""
    Fc = pp.shape[0]
    dev, dt = pp.device, pp.dtype
    grad = torch.zeros((Fc, 3, 3), dtype=dt, device=dev)
    d0v = torch.arange(is_, dtype=dt, device=dev)
    d1v = d0v
    d1_ints = torch.arange(is_, device=dev)[None, None, :]
    fi_flat = fi_map.reshape(-1)

    for edge_num in range(3):
        for axis in range(2):
            r = _edge_rows(pp, front, fids, fi_flat, is_, edge_num, axis)

            # maps viewed so that M[d0, d1] is the cell (axis 0: transposed)
            def cells(m):
                return m.transpose(0, 1) if axis == 0 else m

            ddiff = d1v[None, None, :] - r.d1_cross[:, :, None]      # [Fc,is,is]
            base = (r.p10 - r.p00)[:, None, None] * ddiff * 2.0 / is_
            den1 = (r.p10[:, None] - d0v)[..., None]                 # [Fc,is,1]
            den2 = (d0v - r.p00[:, None])[..., None]

            def dist_terms(diff_grad, active):
                """-diff/dist for the edge's two endpoints."""
                m = active & (diff_grad > 0)
                out = []
                for den in (den1, den2):
                    ok = m & (den.abs() > 0)
                    dist = base / torch.where(ok, den, 1.0)
                    dist = torch.where(dist > 0, dist + eps, dist - eps)
                    out.append(torch.where(ok, diff_grad / dist, 0.0).sum(dim=(1, 2)))
                upd = torch.zeros_like(grad)
                upd[:, r.pi[0], 1 - axis] -= out[0]
                upd[:, r.pi[1], 1 - axis] -= out[1]
                return upd

            def diff_against(idx):
                """sum over channels of (map - map at the crossing pixel) * grad."""
                diff = torch.zeros((Fc, is_, is_), dtype=dt, device=dev)
                if return_alpha:
                    a_x = alpha_map.reshape(-1)[idx]                 # [Fc,is]
                    diff = diff + (cells(alpha_map) - a_x[:, :, None]) * cells(ga_map)
                if return_rgb:
                    r_x = rgb_map.reshape(-1, 3)[idx]                # [Fc,is,3]
                    t = [(cells(rgb_map[..., k]) - r_x[:, :, None, k]) * cells(gr_map[..., k])
                         for k in range(3)]
                    diff = diff + (t[0] + t[1] + t[2])
                return diff

            in_range_out = (d1_ints >= r.lo_out[:, :, None]) & \
                (d1_ints <= r.hi_out[:, :, None]) & r.out_ok[:, :, None]
            grad = grad + dist_terms(diff_against(r.idx_in), in_range_out)

            own = cells(fi_map)[None] == fids[:, None, None]
            in_range_in = (d1_ints >= r.lo_in[:, :, None]) & \
                (d1_ints <= r.hi_in[:, :, None]) & r.in_ok[:, :, None] & own
            grad = grad + dist_terms(diff_against(r.idx_out), in_range_in)
    return grad


def _positive_cells(r, fids, axis, fi_map, channels, row_chunk=4096):
    """Of one (edge, axis) case's scanned cells, how many have a positive
    difference: sum over ``channels`` (pairs of a map and its incoming
    gradient, each [is, is]) of (map - map at the crossing pixel) * grad.
    Only those cells need their distances."""
    def cells(m):
        return (m.transpose(0, 1) if axis == 0 else m).contiguous()

    fi_c = cells(fi_map)
    ch_c = [(m.reshape(-1), cells(m), cells(g)) for m, g in channels]
    is_ = fi_c.shape[0]
    d1 = torch.arange(is_, device=fi_c.device)[None]
    fsel, d0sel = torch.nonzero(r.out_ok | r.in_ok, as_tuple=True)
    n_pos = 0
    for c0 in range(0, fsel.numel(), row_chunk):
        fs, d0 = fsel[c0:c0 + row_chunk], d0sel[c0:c0 + row_chunk]

        def diff_against(idx):
            return sum((m_c[d0] - m_flat[idx[fs, d0]][:, None]) * g_c[d0]
                       for m_flat, m_c, g_c in ch_c)

        def in_range(ok, lo, hi):
            return ok[fs, d0][:, None] & (d1 >= lo[fs, d0][:, None]) & \
                (d1 <= hi[fs, d0][:, None])

        out_m = in_range(r.out_ok, r.lo_out, r.hi_out)
        in_m = in_range(r.in_ok, r.lo_in, r.hi_in) & (fi_c[d0] == fids[fs][:, None])
        n_pos += int((out_m & (diff_against(r.idx_in) > 0)).sum())
        n_pos += int((in_m & (diff_against(r.idx_out) > 0)).sum())
    return n_pos


def edge_scan_census(face, face_index, is_, channels=None, face_chunk=1024):
    """How much an edge walk has to scan on these inputs, counted with the
    sweep's own predicates: (d0 rows crossed, cells of the OUT scans, cells
    of the IN scans, the most cells of one (face, edge, axis) item, the
    scanned cells with a positive difference).  ``channels``: per batch
    element a list of (map, incoming gradient) pairs, each [is, is]; without
    it the last count is None."""
    B, F = face.shape[:2]
    rows = out_cells = in_cells = longest = 0
    positive = None if channels is None else 0
    for b in range(B):
        pp_all = _pixel_space(face[b].reshape(F, 3, 3)[:, :, :2], is_)
        front_all = _face_frontside_n3mr(face[b])
        fi_map = face_index[b].long()
        fi_flat = fi_map.reshape(-1)
        for f0 in range(0, F, face_chunk):
            sl = slice(f0, f0 + face_chunk)
            fids = torch.arange(F, device=face.device)[sl]
            for edge_num in range(3):
                for axis in range(2):
                    r = _edge_rows(pp_all[sl], front_all[sl], fids, fi_flat, is_,
                                   edge_num, axis)
                    n_out = torch.where(r.out_ok, r.hi_out - r.lo_out + 1, 0)
                    n_in = torch.where(r.in_ok, (r.hi_in - r.lo_in + 1).clamp_min(0), 0)
                    rows += int((r.out_ok | r.in_ok).sum())
                    out_cells += int(n_out.sum())
                    in_cells += int(n_in.sum())
                    longest = max(longest, int((n_out + n_in).sum(dim=1).max()))
                    if channels is not None:
                        positive += _positive_cells(r, fids, axis, fi_map, channels[b])
    return rows, out_cells, in_cells, longest, positive


def backward_pixel_map(face, face_index, rgb_map, alpha_map, grad_rgb, grad_alpha,
                       is_, eps, return_rgb, return_alpha, faces=None,
                       face_chunk=None):
    """NMR edge gradient [B,F,9] as a plane sweep (rasterize.py:342-660):
    the x and y columns only, z stays 0.  face [B,F,9]; maps [B,H,W(,3)].

    For each (edge, axis) case the reference walks the edge along d0 and
    scans a range of d1; here every (face, d0, d1) cell is evaluated in
    one masked [Fc, is, is] grid, chunked over faces, O(F * is^2) in all.
    A face's gradient depends only on the maps, so ``faces`` (face ids,
    [n]) restricts the sweep to those faces of every batch element and
    the result is [B,n,9]."""
    B, F = face.shape[:2]
    dev = face.device
    ids = torch.arange(F, device=dev) if faces is None else \
        torch.as_tensor(faces, device=dev).long()
    n = ids.numel()
    if face_chunk is None:
        # ~20 [Fc, is, is] buffers are live at once
        face_chunk = max(1, min(256, (1 << 22) // (is_ * is_)))
    out = torch.zeros((B, n, 3, 3), dtype=face.dtype, device=dev)
    for b in range(B):
        fb = face[b, ids]
        pp = _pixel_space(fb.reshape(n, 3, 3)[:, :, :2], is_)
        front = _face_frontside_n3mr(fb)
        for f0 in range(0, n, face_chunk):
            sl = slice(f0, f0 + face_chunk)
            out[b, sl] = _edge_grads(
                pp[sl], front[sl], ids[sl], face_index[b].long(), alpha_map[b],
                grad_alpha[b], rgb_map[b], grad_rgb[b], is_, eps, return_rgb, return_alpha)
    return out.reshape(B, n, 9)
