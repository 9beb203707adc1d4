"""Texture baking and sampling (plain PyTorch, vectorised over faces and texels).

Counterpart of ``jrender_tpu/ops/texture.py:27-226``; the reference kernels are
  * _load_textures_for_softras -- jrender/io/utils/load_textures.py:3-101
  * _load_textures_for_n3mr    -- load_textures.py:103-247 (wrap modes)
  * create_texture_image       -- jrender/io/utils/create_texture_image.py:3
  * bump->normal               -- _load_obj_for_softras.py:9-15
  * create_TBN                 -- jrender/Scene/objects/utils/create_TBN.py:6-28

Each is one gather per texel over all faces at once, on the device of its
inputs; they run when a mesh is loaded or saved and in SSS's resampling.
The texel's UV point is mixed from the face's three corners by products
added left to right (``_mix3``), not by a matrix product, whose summation
order differs between the CPU and the card, and the texels' barycentric
weights are made on the CPU (the card divides by a scalar through its
reciprocal): a texel then reads the same image bits on both.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.math import normalize

WRAPPING = {'REPEAT': 0, 'MIRRORED_REPEAT': 1, 'CLAMP_TO_EDGE': 2, 'CLAMP_TO_BORDER': 3}


def _bilinear_fetch(image, pos_x, pos_y):
    """Bilinear sample with truncation and clamped neighbours (the
    reference's (int) casts; out-of-range indices clamp to the edge)."""
    H, W = image.shape[0], image.shape[1]
    x0 = pos_x.to(torch.int64).clamp(0, W - 1)
    y0 = pos_y.to(torch.int64).clamp(0, H - 1)
    x1 = (x0 + 1).clamp(0, W - 1)
    y1 = (y0 + 1).clamp(0, H - 1)
    wx1 = pos_x - x0.to(pos_x.dtype)
    wx0 = 1.0 - wx1
    wy1 = pos_y - y0.to(pos_y.dtype)
    wy0 = 1.0 - wy1
    return (image[y0, x0] * (wx0 * wy0)[..., None] +
            image[y1, x0] * (wx0 * wy1)[..., None] +
            image[y0, x1] * (wx1 * wy0)[..., None] +
            image[y1, x1] * (wx1 * wy1)[..., None])


def _mix3(w, corners):
    """w [T,3] weights of corners [F,3,C]: [F,T,C], w0*c0 + w1*c1 + w2*c2
    added left to right."""
    wf = w[None, :, :, None]
    c = corners[:, None]
    return (wf[:, :, 0] * c[:, :, 0] + wf[:, :, 1] * c[:, :, 1]) + wf[:, :, 2] * c[:, :, 2]


def _surface_texel_barycentric(texture_res: int, device=None):
    """Barycentric centres of the R x R triangular half-grid texels: [R*R, 3],
    made on the CPU."""
    R = texture_res
    idx = torch.arange(R * R)
    w_y = (idx % (R * R)) // R
    w_x = idx % R
    low = w_x + w_y < R
    w0 = torch.where(low, (w_x + 1.0 / 3.0) / R, ((R - 1.0 - w_x) + 2.0 / 3.0) / R)
    w1 = torch.where(low, (w_y + 1.0 / 3.0) / R, ((R - 1.0 - w_y) + 2.0 / 3.0) / R)
    w2 = 1.0 - w0 - w1
    return torch.stack([w0, w1, w2], dim=-1).float().to(device)


def load_textures_softras(image, face_texcoords, textures, is_update):
    """Bake a UV image into per-face-texel colours.

    image [H,W,3] (flipped vertically by the caller, as in the reference),
    face_texcoords [F,3,2] in [0,1], textures [F,T,3] initial values,
    is_update [F] int mask.  Returns the new [F,T,3].
    """
    F, T = textures.shape[:2]
    R = math.isqrt(T)
    w = _surface_texel_barycentric(R, textures.device)          # [T,3]
    H, W = image.shape[:2]
    uv = _mix3(w, face_texcoords)                                # [F,T,2]
    c = _bilinear_fetch(image, uv[..., 0] * (W - 1), uv[..., 1] * (H - 1))
    upd = (is_update != 0)[:, None, None]
    return torch.where(upd, c, textures)


def _wrap_uv(uv, mode: int):
    if mode == WRAPPING['REPEAT']:
        return torch.remainder(uv, 1.0)
    if mode == WRAPPING['MIRRORED_REPEAT']:
        m2 = torch.remainder(uv, 2.0)
        return torch.where(m2 < 1, torch.remainder(uv, 1.0), 1.0 - torch.remainder(uv, 1.0))
    if mode == WRAPPING['CLAMP_TO_EDGE']:
        return uv.clamp(0.0, 1.0)
    return uv  # CLAMP_TO_BORDER: zeroed after the fetch


def load_textures_n3mr(image, face_texcoords, textures, is_update,
                       texture_wrapping: int = 0, use_bilinear: bool = True):
    """Bake a UV image into [F,ts,ts,ts,3] volumetric per-face textures,
    with the reference's wrap modes (load_textures.py:103-247)."""
    F, ts = textures.shape[0], textures.shape[1]
    idx = torch.arange(ts ** 3)                  # the weights, made on the CPU
    dim0 = ((idx // (ts * ts)) % ts) / (ts - 1.0)
    dim1 = ((idx // ts) % ts) / (ts - 1.0)
    dim2 = (idx % ts) / (ts - 1.0)
    s = dim0 + dim1 + dim2
    scale = torch.where(s > 0, 1.0 / s.clamp_min(1e-30), 1.0)
    d = (torch.stack([dim0, dim1, dim2], -1) * scale[:, None]).float().to(textures.device)

    uv = _wrap_uv(face_texcoords, texture_wrapping)                      # [F,3,2]
    H, W = image.shape[:2]
    pos = _mix3(d, uv)                                                    # [F,ts^3,2]
    pos_x = pos[..., 0] * (W - 1)
    pos_y = pos[..., 1] * (H - 1)
    if use_bilinear:
        c = _bilinear_fetch(image, pos_x, pos_y)
    else:
        xi = torch.round(pos_x).to(torch.int64).clamp(0, W - 1)
        yi = torch.round(pos_y).to(torch.int64).clamp(0, H - 1)
        c = image[yi, xi]
    if texture_wrapping == WRAPPING['CLAMP_TO_BORDER']:
        c = torch.zeros_like(c)
    c = c.reshape(F, ts, ts, ts, 3)
    upd = (is_update != 0)[:, None, None, None, None]
    return torch.where(upd, c, textures)


def create_texture_image(textures, texture_res_out: int = 16):
    """Pack per-face textures [F, R*R, 3] into a tiled atlas image and
    per-face UVs (reference jrender/io/save_obj.py:7-29 and
    create_texture_image.py:3).  Returns (image [Ht,Wt,3], vertices_uv
    [F,3,2]) as numpy arrays; the atlas is computed on the textures' device."""
    textures = torch.as_tensor(textures, dtype=torch.float32)
    dev = textures.device
    num_faces, T = textures.shape[:2]
    R = math.isqrt(T)
    tile_width = int((num_faces - 1.0) ** 0.5) + 1
    tile_height = int((num_faces - 1.0) / tile_width) + 1
    tr = texture_res_out

    verts = np.zeros((num_faces, 3, 2), np.float32)
    face_nums = np.arange(num_faces)
    column = face_nums % tile_width
    row = face_nums // tile_width
    verts[:, 0, 0] = column * tr + tr / 2.0
    verts[:, 0, 1] = row * tr + 1
    verts[:, 1, 0] = column * tr + 1
    verts[:, 1, 1] = (row + 1) * tr - 2
    verts[:, 2, 0] = (column + 1) * tr - 2
    verts[:, 2, 1] = (row + 1) * tr - 2

    Ht, Wt = tile_height * tr, tile_width * tr
    ys, xs = torch.meshgrid(torch.arange(Ht, device=dev), torch.arange(Wt, device=dev),
                            indexing='ij')
    # the reference kernel computes fn = (x/tr) + (y/tr)*tile_width through
    # variables named row/column swapped (create_texture_image.py:27-29)
    fn = xs // tr + (ys // tr) * tile_width
    fn_safe = fn.clamp(0, num_faces - 1)
    vj = torch.as_tensor(verts, device=dev)[fn_safe]                 # [Ht,Wt,3,2]
    p0, p1, p2 = vj[..., 0, :], vj[..., 1, :], vj[..., 2, :]
    eps = 1e-5
    inv = torch.stack([
        p1[..., 1] - p2[..., 1], p2[..., 0] - p1[..., 0],
        p1[..., 0] * p2[..., 1] - p2[..., 0] * p1[..., 1],
        p2[..., 1] - p0[..., 1], p0[..., 0] - p2[..., 0],
        p2[..., 0] * p0[..., 1] - p0[..., 0] * p2[..., 1],
        p0[..., 1] - p1[..., 1], p1[..., 0] - p0[..., 0],
        p0[..., 0] * p1[..., 1] - p1[..., 0] * p0[..., 1],
    ], -1)
    det = (p2[..., 0] * (p0[..., 1] - p1[..., 1]) + p0[..., 0] * (p1[..., 1] - p2[..., 1]) +
           p1[..., 0] * (p2[..., 1] - p0[..., 1]))
    inv = (inv / (det + eps)[..., None]).reshape(inv.shape[:-1] + (3, 3))
    x = xs.float()
    y = ys.float()
    w = inv[..., 0] * x[..., None] + inv[..., 1] * y[..., None] + inv[..., 2]
    w = w.clamp(0.0, 1.0)
    w = w / (w.sum(-1, keepdim=True) + eps)
    w_x = (w[..., 0] * R).to(torch.int64)
    w_y = (w[..., 1] * R).to(torch.int64)
    low = (w[..., 0] + w[..., 1]) * R - w_x - w_y <= 1
    wxc = w_x.clamp(0, R - 1)
    wyc = w_y.clamp(0, R - 1)
    tidx = torch.where(low, wyc * R + wxc,
                       (R - 1 - w_y).clamp(0, R - 1) * R + (R - 1 - w_x).clamp(0, R - 1))
    img = textures[fn_safe, tidx]
    img = torch.where((fn < num_faces)[..., None], img, 1.0)
    image = img.cpu().numpy()

    verts[:, :, 0] /= (Wt - 1)
    verts[:, :, 1] /= (Ht - 1)
    return image[::-1], verts


def bump_to_normal(bump_image: torch.Tensor) -> torch.Tensor:
    """Bump (height) map [H,W] -> normal map [H-2,W-2,3] in [0,1] by central
    differences (reference _load_obj_for_softras.py:9-15)."""
    h = bump_image
    xy = torch.full((h.shape[0] - 2, h.shape[1] - 2), 6.0, dtype=h.dtype, device=h.device)
    n = -torch.stack((h[1:-1, :-2] - h[1:-1, 2:],
                      h[:-2, 1:-1] - h[2:, 1:-1],
                      -xy), dim=2)
    n = n / torch.linalg.vector_norm(n, dim=2, keepdim=True).clamp_min(1e-5)
    return (n + 1.0) / 2.0


def create_TBN(face_texcoords, face_wcoords):
    """Per-face tangent/bitangent/normal frame [F,3,3] (rows T, B, N)
    (reference create_TBN.py:6-28)."""
    e1 = face_wcoords[:, 0] - face_wcoords[:, 1]
    e2 = face_wcoords[:, 0] - face_wcoords[:, 2]
    n = normalize(torch.linalg.cross(e1, e2, dim=-1), axis=-1, eps=1e-12)[:, None, :]
    u1 = face_texcoords[:, 0, 0] - face_texcoords[:, 1, 0]
    v1 = face_texcoords[:, 0, 1] - face_texcoords[:, 1, 1]
    u2 = face_texcoords[:, 0, 0] - face_texcoords[:, 2, 0]
    v2 = face_texcoords[:, 0, 1] - face_texcoords[:, 2, 1]
    denom = (1.0 / (u1 * v2 - u2 * v1))[:, None, None]
    # the tangent row of inverse @ [e1; e2], inverse = [[v2, -v1], [-u2, u1]]
    T = denom * (v2[:, None, None] * e1[:, None] + (-v1)[:, None, None] * e2[:, None])
    T = T - (T * n).sum(-1, keepdim=True) * n
    T = normalize(T, axis=-1)
    B = normalize(torch.linalg.cross(n, T, dim=-1), axis=-1)
    return torch.cat([T, B, n], dim=1)
