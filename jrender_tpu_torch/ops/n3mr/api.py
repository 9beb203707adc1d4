"""Public N3MR entry points.

Counterpart of ``jrender_tpu/ops/n3mr/api.py`` (reference
``jrender/renderer/dr/n3mr/n3mr.py:189-346`` and ``rasterizer.py``):
``rasterize_rgbad``, ``rasterize``, ``rasterize_silhouettes``,
``rasterize_depth`` and the ``N3mrRasterizer`` module facade.

The gradient is N3MR's own: the vertex gradient of rgb and alpha is a
hand-defined finite difference across each edge, not the derivative of
the z-buffer, so the core is an autograd Function with an explicit
backward and autograd never differentiates the forward.  The inputs go to
the caller's device (the card unless ``device='cpu'``); every stage then
goes by that device: CUDA to the hand-written kernels, CPU to the plain
versions.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.autograd.function import once_differentiable

from ..._device import device_constant, resolve_device
from ...utils.profiling import annotate
from . import cuda_impl, torch_impl

DEFAULT_IMAGE_SIZE = 256
DEFAULT_ANTI_ALIASING = True
DEFAULT_NEAR = 0.1
DEFAULT_FAR = 100
DEFAULT_EPS = 1e-4
DEFAULT_BACKGROUND_COLOR = (0, 0, 0)


@dataclasses.dataclass(frozen=True)
class N3mrParams:
    image_size: int
    near: float
    far: float
    eps: float
    background_color: tuple
    return_rgb: bool
    return_alpha: bool
    return_depth: bool


class N3mrRasterizeCore(torch.autograd.Function):
    """(rgb [B,H,W,3], alpha [B,H,W], depth [B,H,W]) in the rasterizer's
    own orientation from faces [B,F,3,3] and textures [B,F,ts,ts,ts,3]."""

    @staticmethod
    def forward(ctx, faces, textures, p: N3mrParams):
        B = faces.shape[0]
        is_ = p.image_size
        face9 = faces.reshape(B, -1, 9).contiguous()
        rows, fi, wt, dp, finv, zc, rgb = cuda_impl.forward_maps(
            face9, textures.contiguous() if p.return_rgb else None, is_,
            p.near, p.far, p.eps)
        alpha = (fi >= 0).to(face9.dtype)
        if p.return_rgb:
            bg = device_constant(p.background_color, face9.device, face9.dtype)
            mask = alpha[..., None]
            rgb = rgb * mask + (1 - mask) * bg
        else:
            rgb = face9.new_zeros((B, is_, is_, 3))
        ctx.p = p
        ctx.tex_shape = tuple(textures.shape)
        ctx.save_for_backward(face9, rows, *torch_impl.N3mrMaps(
            face_index=fi, weight=wt, depth=dp, face_inv=finv, zcorn=zc, rgb=rgb,
            alpha=alpha))
        return rgb, alpha, dp

    @staticmethod
    @once_differentiable
    def backward(ctx, g_rgb, g_alpha, g_depth):
        with annotate('jr.raster.backward'):
            face9, rows, *maps = ctx.saved_tensors
            m = torch_impl.N3mrMaps(*maps)
            p = ctx.p
            grad_faces = grad_tex = None
            if ctx.needs_input_grad[0]:
                grad_faces = torch.zeros_like(face9)
                if p.return_rgb or p.return_alpha:
                    grad_faces = grad_faces + cuda_impl.backward_pixel_map(
                        face9, m.face_index, m.rgb, m.alpha, g_rgb.contiguous(),
                        g_alpha.contiguous(), p.image_size, p.eps, p.return_rgb, p.return_alpha)
                if p.return_depth:
                    grad_faces = grad_faces + torch_impl.backward_depth(
                        face9, m.face_index, m.face_inv, m.weight, m.depth, m.zcorn, g_depth)
                grad_faces = grad_faces.reshape(face9.shape[0], -1, 3, 3)
            if ctx.needs_input_grad[1]:
                if p.return_rgb:
                    grad_tex = cuda_impl.backward_textures(
                        rows, ctx.tex_shape, m.face_index, m.weight, m.depth, m.zcorn,
                        g_rgb.contiguous(), p.eps)
                else:
                    grad_tex = face9.new_zeros(ctx.tex_shape)
        return grad_faces, grad_tex, None


def vertices_to_faces(vertices, faces):
    """[B,V,3], [B,F,3] -> [B,F,3,3] (rasterizer.py:9-24)."""
    if vertices.dim() != 3 or faces.dim() != 3:
        raise ValueError('vertices_to_faces takes vertices [B,V,3] and faces [B,F,3]')
    b = torch.arange(vertices.shape[0], device=vertices.device)[:, None, None]
    return vertices[b, faces.long()]


def pool2x(x):
    """2x2 mean pool of [B,H,W] or [B,H,W,C]."""
    B, H, W = x.shape[:3]
    if x.dim() == 3:
        return x.reshape(B, H // 2, 2, W // 2, 2).mean(dim=(2, 4))
    return x.reshape(B, H // 2, 2, W // 2, 2, x.shape[-1]).mean(dim=(2, 4))


def rasterize_rgbad(faces, textures=None, image_size=DEFAULT_IMAGE_SIZE,
                    anti_aliasing=DEFAULT_ANTI_ALIASING, near=DEFAULT_NEAR,
                    far=DEFAULT_FAR, eps=DEFAULT_EPS,
                    background_color=DEFAULT_BACKGROUND_COLOR,
                    return_rgb=True, return_alpha=True, return_depth=True,
                    device=None):
    """faces [B,F,3,3] NDC, textures [B,F,ts,ts,ts,3].  Returns
    dict(rgb [B,3,H,W], alpha [B,H,W], depth [B,H,W]); an output that was
    not asked for is None."""
    dev = resolve_device(device)
    size = image_size * 2 if anti_aliasing else image_size
    p = N3mrParams(image_size=size, near=float(near), far=float(far), eps=float(eps),
                   background_color=tuple(float(c) for c in background_color)
                   if background_color is not None else (0.0, 0.0, 0.0),
                   return_rgb=return_rgb, return_alpha=return_alpha,
                   return_depth=return_depth)
    faces = torch.as_tensor(faces, dtype=torch.float32, device=dev)
    if textures is None:
        B, F = faces.shape[:2]
        textures = torch.zeros((B, F, 1, 1, 1, 3), dtype=torch.float32, device=dev)
    textures = torch.as_tensor(textures, dtype=torch.float32, device=dev)

    rgb, alpha, depth = N3mrRasterizeCore.apply(faces, textures, p)

    # vertical flip (n3mr.py:247-253), then the anti-aliasing resolve
    rgb = rgb.permute(0, 3, 1, 2).flip(2)
    alpha = alpha.flip(1)
    depth = depth.flip(1)
    if anti_aliasing:
        B, C, H, W = rgb.shape
        rgb = rgb.reshape(B, C, H // 2, 2, W // 2, 2).mean(dim=(3, 5))
        alpha = pool2x(alpha)
        depth = pool2x(depth)
    return {'rgb': rgb if return_rgb else None,
            'alpha': alpha if return_alpha else None,
            'depth': depth if return_depth else None}


def rasterize(faces, textures, image_size=DEFAULT_IMAGE_SIZE,
              anti_aliasing=DEFAULT_ANTI_ALIASING, near=DEFAULT_NEAR,
              far=DEFAULT_FAR, eps=DEFAULT_EPS,
              background_color=DEFAULT_BACKGROUND_COLOR, device=None):
    return rasterize_rgbad(faces, textures, image_size, anti_aliasing, near, far,
                           eps, background_color, True, False, False, device)['rgb']


def rasterize_silhouettes(faces, image_size=DEFAULT_IMAGE_SIZE,
                          anti_aliasing=DEFAULT_ANTI_ALIASING,
                          near=DEFAULT_NEAR, far=DEFAULT_FAR, eps=DEFAULT_EPS,
                          device=None):
    return rasterize_rgbad(faces, None, image_size, anti_aliasing, near, far,
                           eps, None, False, True, False, device)['alpha']


def rasterize_depth(faces, image_size=DEFAULT_IMAGE_SIZE,
                    anti_aliasing=DEFAULT_ANTI_ALIASING, near=DEFAULT_NEAR,
                    far=DEFAULT_FAR, eps=DEFAULT_EPS, device=None):
    return rasterize_rgbad(faces, None, image_size, anti_aliasing, near, far,
                           eps, None, False, False, True, device)['depth']


def fill_back_faces(faces):
    """Every face followed by its copy with the corner order reversed:
    faces [B,F,3] vertex ids, or [B,F,3,3] face vertices."""
    return torch.cat([faces, faces.flip(2)], dim=1)


def fill_back_textures(textures):
    """Textures [B,F,ts,ts,ts,3] for ``fill_back_faces``: the copies'
    volumes have the first and third corner's axes swapped."""
    return torch.cat([textures, textures.permute(0, 1, 4, 3, 2, 5)], dim=1)


class N3mrRasterizer:
    """Module facade (rasterizer.py:26-120)."""

    def __init__(self, image_size=256, anti_aliasing=True,
                 background_color=(0, 0, 0), fill_back=True, near=0.1, far=100,
                 device=None):
        self.image_size = image_size
        self.anti_aliasing = anti_aliasing
        self.background_color = background_color
        self.fill_back = fill_back
        self.near = near
        self.far = far
        self.rasterizer_eps = 1e-3
        self.device = device
        # attributes that Renderer.set_* touches, for API parity
        self.sigma_val = None
        self.gamma_val = None
        self.texture_type = 'surface'

    def __call__(self, mesh, mode=None):
        vertices, faces, textures = mesh.vertices, mesh.faces, mesh.textures
        if mode is None:
            return self.render(vertices, faces, textures)
        if mode == 'rgb':
            return self.render_rgb(vertices, faces, textures)
        if mode == 'silhouettes':
            return self.render_silhouettes(vertices, faces)
        if mode == 'depth':
            return self.render_depth(vertices, faces)
        raise ValueError("mode should be one of None, 'silhouettes' or 'depth'")

    # silhouettes and depth take the default near, far and eps, not the
    # rasterizer's, as the JAX package's facade does
    def _filled(self, faces, textures=None):
        """The faces (and textures) with fill_back's copies where it is on:
        a part of the rasterizer's prep."""
        if self.fill_back:
            with annotate('jr.raster.prep'):
                faces = fill_back_faces(faces)
                if textures is not None:
                    textures = fill_back_textures(textures)
        return faces, textures

    def render_silhouettes(self, vertices, faces):
        fv = vertices_to_faces(vertices, self._filled(faces)[0])
        return rasterize_silhouettes(fv, self.image_size, self.anti_aliasing,
                                     device=self.device)

    def render_depth(self, vertices, faces):
        fv = vertices_to_faces(vertices, self._filled(faces)[0])
        return rasterize_depth(fv, self.image_size, self.anti_aliasing,
                               device=self.device)

    def render_rgb(self, vertices, faces, textures):
        faces, textures = self._filled(faces, textures)
        fv = vertices_to_faces(vertices, faces)
        return rasterize(fv, textures, self.image_size, self.anti_aliasing,
                         self.near, self.far, self.rasterizer_eps,
                         self.background_color, device=self.device)

    def render(self, vertices, faces, textures):
        faces, textures = self._filled(faces, textures)
        fv = vertices_to_faces(vertices, faces)
        out = rasterize_rgbad(fv, textures, self.image_size, self.anti_aliasing,
                              self.near, self.far, self.rasterizer_eps,
                              self.background_color, device=self.device)
        return out['rgb'], out['depth'], out['alpha']
