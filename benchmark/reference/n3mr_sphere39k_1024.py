"""The plain reference of n3mr_sphere39k_1024: the lighting and the
transform of ``Renderer.render_mesh`` (``scene``), then N3MR with fill_back
and no anti-aliasing (``n3mr``), and the work those inputs need."""
from __future__ import annotations

from benchmark.reference import n3mr, scene

NEAR, FAR, EPS = 0.1, 100.0, 1e-3     # N3mrRasterizer's own


def render(cfg: dict, vertices, faces, textures, eyes) -> dict:
    """What the program's ``render`` returns, in plain PyTorch and in the
    dtype of ``vertices``; differentiable in ``vertices`` and ``textures``."""
    r = cfg['render']
    if r.get('anti_aliasing', True) or not r.get('fill_back', True):
        raise ValueError('the N3MR reference covers fill_back without anti-aliasing only')
    fv, tex = scene.lit_and_projected(vertices, faces, textures, eyes,
                                      cfg['camera']['viewing_angle'])
    rgb, depth, alpha = n3mr.render(fv, tex, r['image_size'], NEAR, FAR, EPS,
                                    tuple(r.get('background_color', (0.0, 0.0, 0.0))))
    return {'rgb': rgb, 'alpha': alpha, 'depth': depth}


def census(cfg: dict, vertices, faces, textures, eyes) -> dict:
    """The z-buffer's and the edge gradient's counts, summed over views."""
    import torch
    with torch.no_grad():
        fv, _ = scene.lit_and_projected(vertices, faces, textures, eyes,
                                        cfg['camera']['viewing_angle'])
        fv = torch.cat([fv, fv.flip(2)], dim=1)
        total = {}
        for b in range(fv.shape[0]):
            c = n3mr.census_view(fv[b].reshape(-1, 9), cfg['image_size'], NEAR, FAR)
            for k, v in c.items():
                total[k] = total.get(k, 0) + v
    return total


# operations of the least work, counted from the kernels' arithmetic
# (chip_smoke.py's N_OPS_* constants): an fma as two, a division as one
OPS_EDGE = 19       # a front face against a pixel of its box: the inside test
OPS_DEPTH = 32      # inside: barycentrics, clip, normalisation, depth, compare
OPS_SAMPLE = 12     # a drawn pixel: texture coordinates and tent weights ...
OPS_TAP = 2         # ... and a multiply-add per tap and channel (8 x 3)
OPS_TEXROW = 4      # texture gradient: per drawn pixel and texel value
OPS_CHANNEL = 2     # edge gradient: per scanned cell and channel (4)
OPS_ROW = 40        # edge gradient: per row an edge crosses


def least_work(cfg: dict, counts: dict, views: int, backward: bool):
    """(operations, bytes) the rasterizer needs at the least for ``views``
    views with these counts: the forward's tests, depths and fetches, and
    with ``backward`` the texture gradient and the edge walk's cells; each
    input byte read once and each output byte written once."""
    F2 = 2 * cfg['faces']                      # with fill_back
    texels = 1
    for d in cfg['textures']:
        texels *= d
    HW = cfg['image_size'] ** 2
    ops = counts['front_pairs'] * OPS_EDGE + counts['inside'] * OPS_DEPTH \
        + counts['drawn'] * (OPS_SAMPLE + 24 * OPS_TAP)
    nbytes = 4 * views * (F2 * (9 + texels) + 5 * HW)
    if backward:
        ops += counts['drawn'] * (OPS_SAMPLE + texels * OPS_TEXROW) \
            + counts['edge_cells'] * 4 * OPS_CHANNEL + counts['edge_rows'] * OPS_ROW
        nbytes += 4 * views * (5 * HW + F2 * (9 + texels))
    return ops, nbytes
