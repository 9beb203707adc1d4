"""N3MR (Kato et al. 2018) in plain PyTorch, over the (pixel, face) pairs
and edge cells that can touch.

The semantics are the port's documented ones (``jrender_tpu_torch/ops/
n3mr/torch_impl.py``, ``ops/n3mr/api.py``): the z-buffer (per pixel the
nearest front face that passes the strict inside test with near < depth <
far, the lowest face id on a tie), the trilinear texture fetch, the
texture gradient summed per winner, the analytic depth gradient, and NMR's
hand-defined edge gradient of rgb and alpha.  The per-pair and per-cell
arithmetic is a frozen copy of that file's (``_pair_terms``,
``maps_of_winners``, ``tent_weights``, ``_edge_rows``, ``_edge_cells``).

Where the port's plain version tests every face at every pixel and sweeps
every (face, row, cell) of the image, this one lists each face's pixel box
(pixel centres in its bounding box) and, for each edge, each row it crosses
and only the cells its two scans cover, and reduces by scatters.
"""
from __future__ import annotations

import math

import torch

ROW_INV = 9
ROW_FRONT = 18
CHUNK = 1 << 22            # pairs or cells evaluated at once


def frontside(face):
    return ~((face[..., 7] - face[..., 1]) * (face[..., 3] - face[..., 0]) <
             (face[..., 4] - face[..., 1]) * (face[..., 6] - face[..., 0]))


def pixel_space(v, is_):
    return 0.5 * (v * is_ + is_ - 1)


def face_rows(face, is_):
    """[F,19]: face 9, pixel-space inverse 9 (0 where not finite), front."""
    px, py = pixel_space(face[..., 0::3], is_), pixel_space(face[..., 1::3], is_)
    x0, x1, x2 = px[..., 0], px[..., 1], px[..., 2]
    y0, y1, y2 = py[..., 0], py[..., 1], py[..., 2]
    inv = torch.stack([y1 - y2, x2 - x1, x1 * y2 - x2 * y1,
                       y2 - y0, x0 - x2, x2 * y0 - x0 * y2,
                       y0 - y1, x1 - x0, x0 * y1 - x1 * y0], -1)
    det = x2 * (y0 - y1) + x0 * (y1 - y2) + x1 * (y2 - y0)
    inv = inv / det[..., None]
    inv = torch.where(torch.isfinite(inv), inv, 0.0)
    return torch.cat([face, inv, frontside(face).to(face.dtype)[..., None]], dim=-1)


def coords(pix, is_, dtype):
    XI = (pix % is_).to(dtype)
    YI = torch.div(pix, is_, rounding_mode='floor').to(dtype)
    return XI, YI, (2.0 * XI + 1 - is_) / is_, (2.0 * YI + 1 - is_) / is_


def pair_terms(r, XI, YI, xp, yp):
    """(inside & front, [w0, w1, w2], depth) of pairs: rows r [P,19]."""
    x0, y0, z0 = r[..., 0], r[..., 1], r[..., 2]
    x1, y1, z1 = r[..., 3], r[..., 4], r[..., 5]
    x2, y2, z2 = r[..., 6], r[..., 7], r[..., 8]
    e0 = (yp - y0) * (x1 - x0) < (xp - x0) * (y1 - y0)
    e1 = (yp - y1) * (x2 - x1) < (xp - x1) * (y2 - y1)
    e2 = (yp - y2) * (x0 - x2) < (xp - x2) * (y0 - y2)
    inside = ~(e0 | e1 | e2) & (r[..., ROW_FRONT] > 0.5)
    w = [(r[..., ROW_INV + 3 * k] * XI + r[..., ROW_INV + 3 * k + 1] * YI
          + r[..., ROW_INV + 3 * k + 2]).clamp(0.0, 1.0) for k in range(3)]
    wsum = w[0] + w[1] + w[2]
    w = [wk / wsum for wk in w]
    return inside, w, 1.0 / (w[0] / z0 + w[1] / z1 + w[2] / z2)


def pairs_of(face, is_):
    """(face ids, pixel ids) [P] of each face's pixel box: the pixel
    centres (integer pixel-space coordinates) within its bounding box."""
    px, py = pixel_space(face[:, 0::3].float(), is_), pixel_space(face[:, 1::3].float(), is_)

    def idx(x):
        return torch.nan_to_num(x, nan=-2.0).clamp(-2, is_ + 1).to(torch.int64)
    c0 = idx(torch.floor(px.amin(-1))).clamp_min(0)
    c1 = idx(torch.ceil(px.amax(-1))).clamp_max(is_ - 1)
    r0 = idx(torch.floor(py.amin(-1))).clamp_min(0)
    r1 = idx(torch.ceil(py.amax(-1))).clamp_max(is_ - 1)
    h, w = (r1 - r0 + 1).clamp_min(0), (c1 - c0 + 1).clamp_min(0)
    n = h * w
    f = torch.repeat_interleave(torch.arange(n.numel(), device=face.device), n)
    k = torch.arange(f.numel(), device=face.device) - (n.cumsum(0) - n)[f]
    wf = w[f]
    return f, (r0[f] + k // wf) * is_ + c0[f] + k % wf


def zbuffer_view(face, is_, near, far):
    """The z-buffer of one view: face [F,9] -> (face_index [HW] int64, -1
    empty; weight [HW,3]; depth [HW]; face_inv [HW,9]; zcorn [HW,3]; rows)."""
    dt, dev = face.dtype, face.device
    F, HW = face.shape[0], is_ * is_
    rows = face_rows(face, is_)
    f_all, pix_all = pairs_of(face, is_)
    zmin = torch.full((HW,), math.inf, dtype=dt, device=dev)
    zs = []
    for s in range(0, f_all.numel(), CHUNK):
        f, pix = f_all[s:s + CHUNK], pix_all[s:s + CHUNK]
        inside, _, zp = pair_terms(rows[f], *coords(pix, is_, dt))
        z = torch.where(inside & (zp > near) & (zp < far), zp, math.inf)
        zmin.scatter_reduce_(0, pix, z, 'amin')
        zs.append(z)
    best = torch.full((HW,), F, dtype=torch.int64, device=dev)
    for s, z in zip(range(0, f_all.numel(), CHUNK), zs):
        f, pix = f_all[s:s + CHUNK], pix_all[s:s + CHUNK]
        hit = torch.isfinite(z) & (z == zmin[pix])
        best.scatter_reduce_(0, pix[hit], f[hit], 'amin')
    has = best < F
    pix = torch.arange(HW, device=dev)
    rw = rows[best.clamp_max(F - 1)]
    XI, YI, xp, yp = coords(pix, is_, dt)
    _, w, _ = pair_terms(rw, XI, YI, xp, yp)
    hm = has[:, None]
    weight = torch.where(hm, torch.stack(w, -1), 0.0)
    depth = torch.where(has, zmin, torch.tensor(far, dtype=dt, device=dev))
    face_inv = torch.where(hm, rw[:, ROW_INV:ROW_INV + 9], 0.0)
    zcorn = torch.where(hm, rw[:, 2:9:3], 1.0)
    return torch.where(has, best, -1), weight, depth, face_inv, zcorn, rows


def tent_weights(tif, ts):
    grid = torch.arange(ts, dtype=tif.dtype, device=tif.device)
    return [(1.0 - (tif[..., a:a + 1] - grid).abs()).clamp_min(0.0) for a in range(3)]


def sampling_tif(weight, depth, zcorn, ts, eps):
    tif = weight * (ts - 1) * (depth[..., None] / zcorn)
    return tif.clamp(0.0, ts - 1 - eps)


def sample_rgb(tex, fi, weight, depth, zcorn, eps):
    """The trilinear fetch: tex [F,ts,ts,ts,3], maps [HW] -> rgb [HW,3]."""
    F, ts = tex.shape[:2]
    has = fi >= 0
    row = tex.reshape(F, -1)[fi.clamp_min(0)]
    tw = tent_weights(sampling_tif(weight, depth, zcorn, ts, eps), ts)
    c1, c2 = ts * ts * 3, ts * 3
    t1 = sum(tw[0][..., i:i + 1] * row[..., i * c1:(i + 1) * c1] for i in range(ts))
    t2 = sum(tw[1][..., j:j + 1] * t1[..., j * c2:(j + 1) * c2] for j in range(ts))
    rgb = sum(tw[2][..., k:k + 1] * t2[..., k * 3:(k + 1) * 3] for k in range(ts))
    return torch.where(has[:, None], rgb, 0.0)


def texture_grad(tex_shape, fi, weight, depth, zcorn, g_rgb, eps):
    """The texture gradient [F,ts,ts,ts,3]: each drawn pixel's tent-weight
    outer product times its rgb gradient, added to its winner."""
    F, ts = tex_shape[:2]
    has = fi >= 0
    tw = tent_weights(sampling_tif(weight, depth, zcorn, ts, eps), ts)
    w01 = tw[0][:, :, None] * tw[1][:, None, :]
    w012 = w01[..., None] * tw[2][:, None, None, :]
    rows = (w012[..., None] * g_rgb[:, None, None, None, :]).reshape(g_rgb.shape[0], -1)
    out = torch.zeros((F, ts ** 3 * 3), dtype=g_rgb.dtype, device=g_rgb.device)
    out.index_add_(0, fi[has], rows[has])
    return out.reshape(tex_shape)


def depth_grad(F, is_, fi, face_inv, weight, depth, zcorn, g_depth):
    """The analytic depth gradient [F,9] of one view."""
    has = fi >= 0
    inv = face_inv.reshape(-1, 3, 3)
    gd = torch.where(has, g_depth, 0.0)
    d2 = depth * depth
    gz = gd[:, None] * weight * d2[:, None] / (zcorn * zcorn)
    tmp = -(inv / zcorn[..., None]).sum(dim=1)
    gxy = -gd[:, None, None] * tmp[:, None, :2] * weight[..., None] * d2[:, None, None] * is_ / 2.0
    gv = torch.cat([gxy, gz[..., None]], -1).reshape(-1, 9)
    out = torch.zeros((F, 9), dtype=g_depth.dtype, device=g_depth.device)
    out.index_add_(0, fi[has], gv[has])
    return out


def _expand(n):
    """(item of each element, position within its item) for lengths n."""
    item = torch.repeat_interleave(torch.arange(n.numel(), device=n.device), n)
    return item, torch.arange(item.numel(), device=n.device) - (n.cumsum(0) - n)[item]


def _item_chunks(n, budget=CHUNK):
    """Item ranges whose elements add up to about ``budget``."""
    ends = torch.searchsorted(n.cumsum(0), torch.arange(budget, int(n.sum()) + budget, budget,
                                                       device=n.device), right=True)
    start = 0
    for e in ends.tolist() + [n.numel()]:
        e = max(e, start + 1)
        if start < n.numel():
            yield start, min(e, n.numel())
        start = e


def edge_grad_view(face, fi, rgb, alpha, g_rgb, g_alpha, is_, eps, count=None):
    """NMR's edge gradient [F,9] of one view (x and y columns; z stays 0):
    face [F,9] NDC, maps [HW(,3)] row-major in the rasterizer's orientation.

    For each face, edge and axis: the d0 rows the edge spans; in each, the
    OUT scan (from the crossing's outside neighbour to the border, where
    the crossing pixel is the face's own) and the IN scan (from the
    crossing to the opposite edge, over the face's own pixels); every cell
    whose difference, sum over channels of (map - map at the crossing's
    other pixel) * gradient, is positive adds diff / dist to both of the
    edge's endpoints, dist = base / den +- eps.  With a dict ``count``,
    only the rows crossed and the cells scanned are counted into it."""
    dt, dev = face.dtype, face.device
    F = face.shape[0]
    pp = pixel_space(face.reshape(F, 3, 3)[:, :, :2], is_)
    front = frontside(face)
    if count is None:
        maps = torch.cat([alpha[:, None], rgb], 1)              # channels: alpha, r, g, b
        grads = torch.cat([g_alpha[:, None], g_rgb], 1)
    out = torch.zeros((F, 3, 3), dtype=dt, device=dev)
    fids = torch.arange(F, device=dev)
    for edge in range(3):
        pi = [(edge + n) % 3 for n in range(3)]
        for axis in range(2):
            p00, p01 = pp[:, pi[0], axis], pp[:, pi[0], 1 - axis]
            p10, p11 = pp[:, pi[1], axis], pp[:, pi[1], 1 - axis]
            p20, p21 = pp[:, pi[2], axis], pp[:, pi[2], 1 - axis]
            sgn = 1.0 if axis == 0 else -1.0
            direction = torch.where(p00 < p10, -1.0, 1.0).to(dt) * sgn
            d0_from = torch.minimum(p00, p10).ceil().clamp_min(0.0)
            d0_to = torch.maximum(p00, p10).clamp_max(is_ - 1.0)
            n_rows = torch.nan_to_num(d0_to.float().floor() - d0_from.float() + 1, nan=0.0)
            n_rows = torch.where(front, n_rows.clamp(0, is_), 0).to(torch.int64)
            it, k = _expand(n_rows)
            d0 = d0_from[it] + k.to(dt)
            a00, a01, a10, a11, a20, a21 = (x[it] for x in (p00, p01, p10, p11, p20, p21))
            dirn = direction[it]
            d1_cross = (a11 - a01) / (a10 - a00) * (d0 - a00) + a01
            up = dirn > 0
            d1_in_f = torch.where(up, d1_cross.floor(), d1_cross.ceil())
            d1_out_f = d1_in_f + dirn
            bd_ok = (d1_in_f >= 0) & (d1_in_f <= is_ - 1) & (d1_out_f >= 0) & (d1_out_f <= is_ - 1)
            d1_in = torch.nan_to_num(d1_in_f).clamp(0, is_ - 1).long()
            d1_out = torch.nan_to_num(d1_out_f).clamp(0, is_ - 1).long()
            d0i = d0.long().clamp(0, is_ - 1)

            def flat(d1):
                return d1 * is_ + d0i if axis == 0 else d0i * is_ + d1
            idx_in, idx_out = flat(d1_in), flat(d1_out)
            fid = fids[it]
            lim_out = torch.where(dirn > 0, is_ - 1, 0)
            between = (d0 - a00) * (d0 - a20) < 0
            cross_a = (a21 - a01) / (a20 - a00) * (d0 - a00) + a01
            cross_b = (a11 - a21) / (a10 - a20) * (d0 - a20) + a21
            cross2 = torch.where(between, cross_a, cross_b)
            lim_in_f = torch.where(up, cross2.ceil(), cross2.floor())
            lim_in = torch.nan_to_num(lim_in_f).clamp(-1, is_).long()
            out_ok = bd_ok & (fi[idx_in] == fid)
            in_ok = bd_ok & torch.isfinite(lim_in_f)
            scans = (
                (out_ok, torch.minimum(d1_out, lim_out).clamp_min(0),
                 torch.maximum(d1_out, lim_out).clamp_max(is_ - 1), idx_in, False),
                (in_ok, torch.minimum(d1_in, lim_in).clamp_min(0),
                 torch.maximum(d1_in, lim_in).clamp_max(is_ - 1), idx_out, True))
            if count is not None:
                count['edge_rows'] = count.get('edge_rows', 0) + int((out_ok | in_ok).sum())
            for ok, lo, hi, idx_x, own in scans:
                sel = torch.nonzero(ok)[:, 0]
                n = (hi[sel] - lo[sel] + 1).clamp_min(0)
                if count is not None:
                    count['edge_cells'] = count.get('edge_cells', 0) + int(n.sum())
                    continue
                for s, e in _item_chunks(n):
                    items = sel[s:e]
                    ci, ck = _expand(n[s:e])
                    item = items[ci]
                    d1 = lo[item] + ck
                    cell = d1 * is_ + d0i[item] if axis == 0 else d0i[item] * is_ + d1
                    x = idx_x[item]
                    diff = (maps[cell, 0] - maps[x, 0]) * grads[cell, 0]
                    t = [(maps[cell, c] - maps[x, c]) * grads[cell, c] for c in (1, 2, 3)]
                    diff = diff + (t[0] + t[1] + t[2])
                    m = diff > 0
                    if own:
                        m = m & (fi[cell] == fid[item])
                    base = (a10[item] - a00[item]) * (d1.to(dt) - d1_cross[item]) * 2.0 / is_
                    f_item = fid[item]
                    for corner, den in ((pi[0], a10[item] - d0[item]), (pi[1], d0[item] - a00[item])):
                        okd = m & (den.abs() > 0)
                        dist = base / torch.where(okd, den, 1.0)
                        dist = torch.where(dist > 0, dist + eps, dist - eps)
                        term = torch.where(okd, diff / dist, 0.0)
                        col = torch.zeros(F, dtype=dt, device=dev)
                        col.index_add_(0, f_item, term)
                        out[:, corner, 1 - axis] -= col
    return out.reshape(F, 9)


class N3mrCore(torch.autograd.Function):
    """(rgb [B,H,W,3], alpha [B,H,W], depth [B,H,W]) in the rasterizer's
    own orientation from faces [B,F,3,3] NDC and textures
    [B,F,ts,ts,ts,3]; the backward is N3MR's own."""

    @staticmethod
    def forward(ctx, faces, textures, is_: int, near: float, far: float, eps: float, bg):
        B = faces.shape[0]
        face9 = faces.reshape(B, -1, 9)
        outs, maps = [], []
        for b in range(B):
            fi, wt, dp, finv, zc, _ = zbuffer_view(face9[b], is_, near, far)
            rgb = sample_rgb(textures[b], fi, wt, dp, zc, eps)
            alpha = (fi >= 0).to(face9.dtype)
            rgb = rgb * alpha[:, None] + (1 - alpha[:, None]) * torch.tensor(
                bg, dtype=face9.dtype, device=face9.device)
            outs.append((rgb, alpha, dp))
            maps.append((fi, wt, dp, finv, zc, rgb, alpha))
        ctx.meta = (is_, eps, tuple(textures.shape[1:]))
        ctx.maps = maps
        ctx.save_for_backward(face9)
        return (torch.stack([o[0] for o in outs]).reshape(B, is_, is_, 3),
                torch.stack([o[1] for o in outs]).reshape(B, is_, is_),
                torch.stack([o[2] for o in outs]).reshape(B, is_, is_))

    @staticmethod
    def backward(ctx, g_rgb, g_alpha, g_depth):
        face9, = ctx.saved_tensors
        is_, eps, tex_shape = ctx.meta
        B, F = face9.shape[:2]
        gf, gt = [], []
        for b in range(B):
            fi, wt, dp, finv, zc, rgb, alpha = ctx.maps[b]
            gr, ga, gd = g_rgb[b].reshape(-1, 3), g_alpha[b].reshape(-1), g_depth[b].reshape(-1)
            gf.append(edge_grad_view(face9[b], fi, rgb, alpha, gr, ga, is_, eps)
                      + depth_grad(F, is_, fi, finv, wt, dp, zc, gd))
            gt.append(texture_grad(tex_shape, fi, wt, dp, zc, gr, eps))
        return (torch.stack(gf).reshape(B, F, 3, 3), torch.stack(gt),
                None, None, None, None, None)


def render(faces, textures, is_: int, near=0.1, far=100.0, eps=1e-3, bg=(0.0, 0.0, 0.0)):
    """``N3mrRasterizer.render`` with fill_back and no anti-aliasing:
    faces [B,F,3,3] NDC, textures [B,F,ts,ts,ts,3] -> (rgb [B,3,H,W],
    depth [B,H,W], alpha [B,H,W]) in the image's orientation."""
    faces = torch.cat([faces, faces.flip(2)], dim=1)
    textures = torch.cat([textures, textures.permute(0, 1, 4, 3, 2, 5)], dim=1)
    rgb, alpha, depth = N3mrCore.apply(faces, textures, is_, near, far, eps, bg)
    return rgb.permute(0, 3, 1, 2).flip(2), depth.flip(1), alpha.flip(1)


def census_view(face, is_, near, far):
    """The work one view's inputs need: pairs of a front face and a pixel
    in its box, those inside it within depth, the drawn pixels, and the
    edge gradient's rows crossed and cells scanned."""
    rows = face_rows(face, is_)
    f_all, pix_all = pairs_of(face, is_)
    front = rows[:, ROW_FRONT] > 0.5
    out = dict(front_pairs=int(front[f_all].sum()), inside=0)
    drawn = torch.zeros(is_ * is_, dtype=torch.bool, device=face.device)
    for s in range(0, f_all.numel(), CHUNK):
        f, pix = f_all[s:s + CHUNK], pix_all[s:s + CHUNK]
        inside, _, zp = pair_terms(rows[f], *coords(pix, is_, face.dtype))
        ok = inside & (zp > near) & (zp < far)
        out['inside'] += int(ok.sum())
        drawn[pix[ok]] = True
    out['drawn'] = int(drawn.sum())
    fi = zbuffer_view(face, is_, near, far)[0]
    edge_grad_view(face, fi, None, None, None, None, is_, 0.0, count=out)
    return out
