"""Public SoftRas entry points.

Counterpart of ``jrender_tpu/ops/softras/api.py`` (``soft_rasterize``
:222, ``soft_rasterize_with_aux`` :254), itself the reference
``soft_rasterize`` (soft_rasterize.py:136-148).  The inputs go to the
caller's device (the card unless ``device='cpu'``); the forward then goes
by that device: CUDA to the hand-written kernel, CPU to the plain version.

The gradient is the reference's top-K truncated backward, as in the JAX
package (``_core_fwd`` / ``_core_bwd``, api.py:141-219), not the
derivative of the forward: ``soft_rasterize`` is an autograd Function
with an explicit backward, and autograd never differentiates the forward.
With ``grad_mode='topk'`` (the default) a pixel sends gradient to its
``max_faces_per_pixel_for_grad`` nearest candidates only; ``'full'``
sends it to every candidate.

Five routes, chosen as the JAX package chooses among its layouts
(``route.route``, read at call time; its docstring has the table): under
``JR_LAYOUT=pxg`` a size divisible by 8 goes to the pxg kernels
(``pxg_impl``), which cut each tile's face list into work items of their
own and merge the items' partial aggregates per tile; under
``JR_LAYOUT=px_f`` to the px_f kernels (``pxf_impl``: t x t tiles, the
threshold in the forward's walk); under ``JR_LAYOUT=f_px`` a size that
16 x min(128, is) tiles divide goes to the f_px kernels (``fpx_impl``),
unless the top-K truncation binds: their backward is untruncated; under
the default layout a mesh of at most ``JR_DIR_MAX`` faces (default 0:
never) on a size divisible by 8 goes to the dir kernels (``dir_impl``),
which walk the whole face table per screen tile and find the threshold in
the forward's own walk; everything else to the binned kernels
(``cuda_impl``).  The backward takes the route its forward took.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..._device import resolve_device
from . import cuda_impl, dir_impl, fpx_impl, pxf_impl, pxg_impl, torch_impl
from .route import route
from .params import SoftRasParams, make_params


class SoftRasterize(torch.autograd.Function):
    """images [B,4,H,W] from face_vertices [B,F,9] and textures;
    ``need_grad`` says whether a backward may follow."""

    @staticmethod
    def forward(ctx, face_vertices, textures, p: SoftRasParams, need_grad: bool):
        ctx.route = route(p, face_vertices.shape[1], need_grad)
        with_thr = need_grad and torch_impl.use_threshold(p, face_vertices.shape[1])
        if ctx.route in _TABLED:
            # the route's table (Morton order, work items or tile lists) is
            # made once and kept for the backward
            table = _prep(ctx.route, face_vertices, textures, p, need_grad)
            images, aggrs, _, thr = _TABLED[ctx.route].forward(table, p, with_thr)
            if need_grad:
                ctx.p = p
                ctx.table = table
                ctx.save_for_backward(face_vertices, textures, images, aggrs, thr)
            return images
        inputs = None
        if face_vertices.device.type == 'cuda':
            # rows and tile lists are made once and kept for the backward
            inputs = cuda_impl.prepare(face_vertices, textures, p, for_grad=need_grad)
            images, aggrs, counts = cuda_impl.launch(inputs, p)
        else:
            images, aggrs, counts = cuda_impl.soft_rasterize_fwd(
                face_vertices, textures, p)
        if need_grad:
            # only a step that asks for a gradient pays for the threshold
            thr = cuda_impl.topk_threshold(face_vertices, p, inputs, counts)
            ctx.p = p
            ctx.inputs = inputs
            ctx.save_for_backward(face_vertices, textures, images, aggrs, thr)
        return images

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_images):
        face_vertices, textures, images, aggrs, thr = ctx.saved_tensors
        if ctx.route in _TABLED:
            grad_face, grad_tex = _TABLED[ctx.route].backward(
                ctx.table, images, aggrs, thr, grad_images, ctx.p)
            grad_tex = grad_tex.reshape(textures.shape)
        else:
            grad_face, grad_tex = cuda_impl.soft_rasterize_bwd(
                face_vertices, textures, images, aggrs, thr, grad_images, ctx.p,
                ctx.inputs)
        return (grad_face if ctx.needs_input_grad[0] else None,
                grad_tex if ctx.needs_input_grad[1] else None, None, None)


# the routes whose forward and backward share a table of their own
_TABLED = {'dir': dir_impl, 'pxg': pxg_impl, 'f_px': fpx_impl, 'px_f': pxf_impl}


def _prep(r: str, face_vertices, textures, p: SoftRasParams, for_grad: bool):
    """The table of route ``r``; ``for_grad`` adds what its backward reads."""
    if r == 'dir':
        return dir_impl.prep_dir(face_vertices, textures, p)
    prep = {'pxg': pxg_impl.prep_pxg, 'f_px': fpx_impl.prep_fpx, 'px_f': pxf_impl.prep_pxf}[r]
    return prep(face_vertices, textures, p, for_grad=for_grad)


def _inputs(face_vertices, textures, texture_type, device):
    dev = resolve_device(device)
    face_vertices = torch.as_tensor(face_vertices, dtype=torch.float32, device=dev)
    textures = torch.as_tensor(textures, dtype=torch.float32, device=dev)
    B, F = face_vertices.shape[:2]
    face_vertices = face_vertices.reshape(B, F, 9).contiguous()
    if texture_type == 'vertex':
        textures = textures.reshape(B, F, 3, 3)
    return face_vertices, textures.contiguous()


def soft_rasterize(face_vertices, textures, image_size=256,
                   background_color=(0, 0, 0), near=1, far=100,
                   fill_back=True, eps=1e-3,
                   sigma_val=1e-5, dist_func='euclidean', dist_eps=1e-4,
                   gamma_val=1e-4, aggr_func_rgb='softmax', aggr_func_alpha='prod',
                   texture_type='surface', bin_size=0, max_elems_per_bin=0,
                   max_faces_per_pixel_for_grad=16, grad_mode='topk',
                   device=None):
    """Soft rasterization; returns images [B, 4, H, W].

    ``face_vertices``: [B, F, 3, 3] (or [B, F, 9]); ``textures``:
    [B, F, T, 3] (surface) or [B, F, 3, 3] (vertex colours per corner).
    ``bin_size`` / ``max_elems_per_bin`` are accepted for API parity; the
    kernel bins the screen into 16-px tiles itself.  ``JR_LAYOUT`` and
    ``JR_DIR_MAX`` (environment) choose the route (see the module
    docstring).
    """
    p = make_params(image_size=image_size, background_color=background_color,
                    near=near, far=far, fill_back=fill_back, eps=eps,
                    sigma_val=sigma_val, dist_func=dist_func, dist_eps=dist_eps,
                    gamma_val=gamma_val, aggr_func_rgb=aggr_func_rgb,
                    aggr_func_alpha=aggr_func_alpha, texture_type=texture_type,
                    max_faces_per_pixel_for_grad=max_faces_per_pixel_for_grad,
                    grad_mode=grad_mode)
    face_vertices, textures = _inputs(face_vertices, textures, texture_type, device)
    # under torch.no_grad() nothing is kept for a backward and the
    # threshold kernel is not launched
    need_grad = torch.is_grad_enabled() and (face_vertices.requires_grad
                                             or textures.requires_grad)
    return SoftRasterize.apply(face_vertices, textures, p, need_grad)


def soft_rasterize_with_aux(face_vertices, textures, p: SoftRasParams,
                            device=None):
    """Forward without autograd: (images [B,4,H,W], aggrs [B,2,H,W],
    counts [B,H,W] int32).  The JAX package's third output is the top-K
    face ids, which only its oracle's backward reads; the port's backward
    reads a depth threshold instead (``cuda_impl.topk_threshold``), which
    a plain forward does not pay for, so the third output here is the
    per-pixel candidate count (the reference's q_size).  The face ids
    themselves are ``torch_impl.topk_face_ids``."""
    face_vertices, textures = _inputs(face_vertices, textures, p.texture_type,
                                      device)
    with torch.no_grad():
        r = route(p, face_vertices.shape[1], False)
        if r in _TABLED:
            table = _prep(r, face_vertices, textures, p, False)
            return _TABLED[r].forward(table, p, False)[:3]
        return cuda_impl.soft_rasterize_fwd(face_vertices, textures, p)
