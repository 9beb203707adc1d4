"""The system under test: ``jrender_tpu_torch``'s ``Renderer.render_mesh``
as a user drives it, and the spans the traced run puts around its layers.

The package is imported when a program is built, never when this module
is: the harness's CPU tests import every module.
"""
from __future__ import annotations


class Program:
    """A ``Renderer`` built from a configuration's ``render`` block, which
    renders a batch of views: one mesh of N copies of the vertices, one
    eye each.  ``outputs`` (per configuration) names what ``render_mesh``
    returns."""

    backward_op = None   # the profiler's name of the rasterizer's autograd node

    def __init__(self, cfg: dict, device=None):
        import jrender_tpu_torch as jr
        self.jr = jr
        self.cfg = cfg
        self.device = device
        self.renderer = jr.Renderer(**cfg['render'], device=device)

    def render(self, vertices, faces, textures, eyes) -> dict:
        """vertices [N,V,3], faces [N,F,3], textures [N,F,...], eyes [N,3]
        -> the configuration's outputs (``rgb`` [N,3,H,W], ``alpha``
        [N,H,W], ...)."""
        self.renderer.transform.set_eyes(eyes)
        mesh = self.jr.Mesh(vertices, faces, textures=textures, texture_type='surface',
                            dr_type=self.cfg['render']['dr_type'], device=self.device)
        return self.outputs(self.renderer.render_mesh(mesh, mode=self.cfg['mode']))

    def outputs(self, out) -> dict:
        raise NotImplementedError

    def add_spans(self):
        """Wrap the renderer's lighting, transform and rasterizer so that
        each call runs inside a profiler range of its own."""
        r = self.renderer
        r.lighting = Spanned(r.lighting, 'renderer.lighting')
        r.transform = Spanned(r.transform, 'renderer.transform')
        r.rasterizer = Spanned(r.rasterizer, 'raster.forward')


class Spanned:
    """Forwards calls, reads and writes to ``inner``; a call runs inside
    ``torch.profiler.record_function(name)``."""

    def __init__(self, inner, name: str):
        object.__setattr__(self, '_inner', inner)
        object.__setattr__(self, '_name', name)

    def __call__(self, *a, **k):
        from torch.profiler import record_function
        with record_function(self._name):
            return self._inner(*a, **k)

    def __getattr__(self, key):
        return getattr(self._inner, key)

    def __setattr__(self, key, value):
        setattr(self._inner, key, value)
