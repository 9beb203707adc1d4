"""Renderer facade: Lighting -> Transform -> Rasterizer.

Counterpart of ``jrender_tpu/renderer/renderer.py`` (reference
``jrender/renderer/renderer.py:10-71``).  A Renderer runs on the card
unless it is built with ``device='cpu'``; with no device and no card it
raises.
"""
from __future__ import annotations

from .._device import resolve_device
from ..lighting import Lighting
from ..ops.n3mr import N3mrRasterizer
from ..structures import Mesh
from ..transform import Transform
from ..utils.profiling import annotate
from .rasterizer import SoftRasterizer


class Renderer:
    def __init__(self, image_size=256, background_color=(0, 0, 0), near=1, far=100,
                 anti_aliasing=False, fill_back=True, eps=1e-3,
                 sigma_val=1e-5, dist_func='euclidean', dist_eps=1e-4,
                 gamma_val=1e-4, aggr_func_rgb='softmax', aggr_func_alpha='prod',
                 texture_type='surface',
                 camera_mode='look_at',
                 K=None, R=None, t=None, dist_coeffs=None, orig_size=512,
                 perspective=True, viewing_angle=30, viewing_scale=1.0,
                 eye=None, camera_direction=(0, 0, 1),
                 light_mode='surface',
                 light_intensity_ambient=0.5, light_color_ambient=(1, 1, 1),
                 light_intensity_directionals=0.5, light_color_directionals=(1, 1, 1),
                 light_directions=(0, 1, 0), dr_type='softras', Gbuffer='None',
                 bin_size=0, max_elems_per_bin=0, max_faces_per_pixel_for_grad=16,
                 device=None):
        self.device = resolve_device(device)
        self.transform = Transform(camera_mode, K, R, t, dist_coeffs, orig_size,
                                   perspective, viewing_angle, viewing_scale,
                                   eye, camera_direction)
        self.lighting = Lighting(light_mode, light_intensity_ambient,
                                 light_color_ambient, light_intensity_directionals,
                                 light_color_directionals, light_directions,
                                 Gbuffer, self.transform)
        self.dr_type = dr_type
        if dr_type == 'softras':
            self.rasterizer = SoftRasterizer(image_size, background_color, near, far,
                                             anti_aliasing, fill_back, eps,
                                             sigma_val, dist_func, dist_eps,
                                             gamma_val, aggr_func_rgb, aggr_func_alpha,
                                             texture_type, bin_size, max_elems_per_bin,
                                             max_faces_per_pixel_for_grad, self.device)
        elif dr_type == 'n3mr':
            # near and far are not passed on: the rasterizer keeps its own
            self.rasterizer = N3mrRasterizer(image_size, anti_aliasing,
                                             background_color, fill_back,
                                             device=self.device)
        else:
            raise ValueError("dr_type should be one of None, 'softras' or 'n3mr'")

    def set_sigma(self, sigma):
        self.rasterizer.sigma_val = sigma

    def set_gamma(self, gamma):
        self.rasterizer.gamma_val = gamma

    def set_texture_mode(self, mode):
        if mode not in ('vertex', 'surface'):
            raise ValueError('Mode only support surface and vertex')
        self.lighting.light_mode = mode
        self.rasterizer.texture_type = mode

    def render_mesh(self, mesh, mode='rgb'):
        """Light, transform and rasterize ``mesh``.  Like the reference it
        rewrites the mesh's textures and vertices; ``mesh.reset_()``
        restores them before the next frame.  Each stage runs in a span of
        its own (``utils/profiling.py``)."""
        with annotate('jr.render_mesh'):
            self.set_texture_mode(mesh.texture_type)
            with annotate('jr.lighting'):
                mesh = self.lighting(mesh, self.transform.eyes)
            with annotate('jr.transform'):
                mesh = self.transform(mesh)
            with annotate('jr.raster'):
                return self.rasterizer(mesh, mode)

    def __call__(self, vertices, faces, textures=None, mode='rgb',
                 texture_type='surface', metallic_textures=None,
                 roughness_textures=None):
        mesh = Mesh(vertices, faces, textures=textures, texture_type=texture_type,
                    metallic_textures=metallic_textures,
                    roughness_textures=roughness_textures, device=self.device)
        return self.render_mesh(mesh, mode)

    # parity alias with the reference's nn.Module.execute
    execute = __call__


class SoftRenderer(Renderer):
    """Alias kept for API parity (the reference exports SoftRenderer)."""
