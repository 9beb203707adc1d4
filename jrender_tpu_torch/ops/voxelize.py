"""Mesh voxelization (plain PyTorch).

Counterpart of ``jrender_tpu/ops/voxelize.py`` (``voxelization`` :127;
reference jrender/renderer/utils/voxelization.py:5-57 and cuda/voxelization.py):
  * sub1: each axis projection's grid points inside each triangle fill the
    cell at the interpolated depth and its (y-1, x-1) neighbours;
  * sub2: the cells of the vertices;
  * sub3/sub4: the empty cells reachable from the border, flood-filled to a
    fixpoint; the solid is everything else.

The JAX function pairs every grid point of a plane with every face at
once; this one walks the faces in chunks of at most ``PAIRS`` (grid point,
face) pairs to bound its memory.  Every scatter writes an integer with
``scatter_reduce_(..., 'amax')``, exact in any order.
"""
from __future__ import annotations

import torch

from .._device import resolve_device

PAIRS = 1 << 24          # (grid point, face) pairs evaluated at once


def _scatter_max(vox, lin, valid):
    """vox[lin] = max(vox[lin], 1) where valid: only the valid entries are
    scattered (sending the others to one spare cell would make every
    thread on the card write to one address)."""
    lin = lin[valid]
    vox.scatter_reduce_(0, lin, torch.ones_like(lin, dtype=vox.dtype), 'amax')


def _sub1_axis(faces, vs):
    """Surface fill for one axis orientation; faces [B,F,3,3] permuted so
    that the scan plane is (coord0, coord1) and depth is coord2
    (voxelize_sub1_kernel, cuda/voxelization.py:31-86)."""
    B, F = faces.shape[:2]
    dev = faces.device
    g = torch.arange(vs, dtype=torch.float32, device=dev)
    Y, X = torch.meshgrid(g, g, indexing='ij')                    # X[i, j] = j, Y[i, j] = i
    f = faces.reshape(B, F, 9)
    y1d = f[..., 3] - f[..., 0]
    x1d = f[..., 4] - f[..., 1]
    z1d = f[..., 5] - f[..., 2]
    y2d = f[..., 6] - f[..., 0]
    x2d = f[..., 7] - f[..., 1]
    z2d = f[..., 8] - f[..., 2]
    det = x1d * y2d - x2d * y1d                                   # [B,F]
    yi = Y.to(torch.int64)[..., None]
    xi = X.to(torch.int64)[..., None]
    out = torch.zeros((B, vs * vs * vs), dtype=torch.int32, device=dev)
    chunk = max(1, PAIRS // (vs * vs))
    for b in range(B):
        for s in range(0, F, chunk):
            sl = slice(s, s + chunk)
            ypd = Y[..., None] - f[b, sl, 0]                      # [vs,vs,c]
            xpd = X[..., None] - f[b, sl, 1]
            d = det[b, sl]
            det_safe = torch.where(d == 0, 1.0, d)
            t1 = (y2d[b, sl] * xpd - x2d[b, sl] * ypd) / det_safe
            t2 = (-y1d[b, sl] * xpd + x1d[b, sl] * ypd) / det_safe
            ok = (d != 0) & (t1 >= 0) & (t2 >= 0) & (t1 + t2 <= 1)
            zi = torch.floor(t1 * z1d[b, sl] + t2 * z2d[b, sl] + f[b, sl, 2]).to(torch.int64)
            zok = ok & (zi >= 0) & (zi < vs)
            zc = zi.clamp(0, vs - 1)
            for dy, dx in ((0, 0), (-1, 0), (0, -1), (-1, -1)):
                yy = yi + dy
                xx = xi + dx
                valid = zok & (yy >= 0) & (yy < vs) & (xx >= 0) & (xx < vs)
                _scatter_max(out[b], (yy * vs + xx) * vs + zc, valid)
    return out.reshape(B, vs, vs, vs)


def voxelize_sub1(faces, size, dim):
    if dim == 0:
        fperm = faces[:, :, :, [2, 1, 0]]
    elif dim == 1:
        fperm = faces[:, :, :, [0, 2, 1]]
    else:
        fperm = faces
    res = _sub1_axis(fperm, size)
    if dim == 0:
        return res.permute(0, 3, 2, 1)
    if dim == 1:
        return res.permute(0, 1, 3, 2)
    return res


def voxelize_sub2(faces, size):
    """Mark the cells that hold vertices (cuda/voxelization.py:138-162)."""
    B = faces.shape[0]
    vs = size
    v = torch.floor(faces).to(torch.int64)             # [B,F,3,3] (y, x, z)
    yi, xi, zi = v[..., 0], v[..., 1], v[..., 2]
    ok = (yi >= 0) & (yi < vs) & (xi >= 0) & (xi < vs) & (zi >= 0) & (zi < vs)
    lin = (yi * vs + xi) * vs + zi.clamp(0, vs - 1)
    out = torch.zeros((B, vs ** 3), dtype=torch.int32, device=faces.device)
    for b in range(B):
        _scatter_max(out[b], lin[b], ok[b])
    return out.reshape(B, vs, vs, vs)


def _dilate(vis, empty):
    p = torch.nn.functional.pad(vis, (1, 1, 1, 1, 1, 1))
    n = (p[:, :-2, 1:-1, 1:-1] | p[:, 2:, 1:-1, 1:-1] |
         p[:, 1:-1, :-2, 1:-1] | p[:, 1:-1, 2:, 1:-1] |
         p[:, 1:-1, 1:-1, :-2] | p[:, 1:-1, 1:-1, 2:])
    return vis | (empty & n)


def _flood_exterior(voxels):
    """sub3 + sub4: the empty cells reachable from the border, to a fixpoint."""
    vs = voxels.shape[1]
    empty = voxels == 0
    border = torch.zeros((vs, vs, vs), dtype=torch.bool, device=voxels.device)
    border[0] = border[-1] = True
    border[:, 0] = border[:, -1] = True
    border[:, :, 0] = border[:, :, -1] = True
    visible = empty & border[None]
    while True:
        nxt = _dilate(visible, empty)
        if torch.equal(nxt, visible):
            break
        visible = nxt
    return 1 - visible.to(torch.int32)


def voxelization(faces, size, normalize=False, device=None):
    """Mesh face vertices [B,F,3,3] -> solid voxel grid [B,size,size,size]
    int32 (voxelization.py:41-57), on ``device``: the card unless
    ``device='cpu'``."""
    faces = torch.as_tensor(faces, dtype=torch.float32, device=resolve_device(device))
    if not normalize:
        faces = faces * size
    v0 = voxelize_sub1(faces, size, 0)
    v1 = voxelize_sub1(faces, size, 1)
    v2 = voxelize_sub1(faces, size, 2)
    v3 = voxelize_sub2(faces, size)
    voxels = ((v0 + v1 + v2 + v3) > 0).to(torch.int32)
    return _flood_exterior(voxels)
