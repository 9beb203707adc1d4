"""The plain reference of softras_sphere39k_1024: the lighting and the
transform of ``Renderer.render_mesh`` (``scene``), then SoftRas with its
top-K truncated gradient (``softras``), and the work those inputs need."""
from __future__ import annotations

from benchmark.reference import scene, softras


def render(cfg: dict, vertices, faces, textures, eyes) -> dict:
    """What the program's ``render`` returns, in plain PyTorch and in the
    dtype of ``vertices``; differentiable in ``vertices`` and ``textures``."""
    fv, tex = scene.lit_and_projected(vertices, faces, textures, eyes,
                                      cfg['camera']['viewing_angle'])
    images = softras.soft_rasterize(fv, tex, softras.params_of(cfg['render']))
    return {'rgb': images[:, :3], 'alpha': images[:, 3]}


def census(cfg: dict, vertices, faces, textures, eyes) -> dict:
    """The pair counts of these inputs, summed over the views."""
    import torch
    with torch.no_grad():
        fv, _ = scene.lit_and_projected(vertices, faces, textures, eyes,
                                        cfg['camera']['viewing_angle'])
        p = softras.params_of(cfg['render'])
        total = {}
        for b in range(fv.shape[0]):
            for k, v in softras.census_view(fv[b].reshape(-1, 9), p).items():
                total[k] = total.get(k, 0) + v
    return total


def least_work(cfg: dict, counts: dict, views: int, backward: bool):
    """(operations, bytes) the rasterizer needs at the least for ``views``
    views with these counts."""
    F = cfg['faces']
    T = cfg['textures'][0]
    return softras.least_work(counts, views, F, T, cfg['image_size'], backward)
