"""Pixel-band sharded SoftRas over torch.distributed.

Counterpart of ``jrender_tpu/parallel/render.py`` (``band_row_src`` :62,
``soft_rasterize_sharded`` :79, ``soft_rasterize_sharded_vjp`` :87).  Each
rank of the mesh's ``'data'`` axis rasterizes a band of the image's rows
against the whole (replicated) face set, through the same kernels as one
card: the forward needs no communication (the softmax aggregation is
pixel-local), the bands are gathered into the whole image, and the face
and texture gradients are summed over the bands.

The band path goes by the inputs' device (the JAX package goes by its
platform, ``_band_uses_pallas`` :30):
  * a CUDA input under ``JR_LAYOUT=pxt`` (the default) where the 16-px
    tile rows divide over the ranks: the binned kernels on a band of tile
    rows (``cuda_impl.prepare(..., band=...)``: K1, its threshold, K2 and
    the reduction), the JAX ``pxt`` band path;
  * a CUDA input under another layout: the px_f kernels on a contiguous
    band of px_f tile rows (``pxf_impl.prep_pxf(..., ty0, ty_band)``,
    render.py:113-114, :154, :219), which must divide over the ranks;
  * a CPU input: the plain versions on the band's pixels
    (``torch_impl.forward_rows``, ``threshold_rows``, ``backward_rows``),
    as the JAX oracle bands (:115-125, ``_band_fwd_oracle`` :43), over
    16-px tile rows where they divide over the ranks, else over
    contiguous bands of H / n rows.
``band_mode='stride'`` (the default) deals the tile rows out round-robin,
rank r taking tile rows r, r + n, r + 2n, ... (render.py:76-95): the
faces of a frame crowd some rows, and striding spreads them over the
ranks.  It applies where the band unit is a 16-px tile row (the binned
kernels and the plain bands; px_f bands stay contiguous, as in the JAX
package).  The gathered bands are put back in image order (the ``inv``
gather, :132-133), so every rank returns the whole image, equal for both
modes.

A rank's work is a plain function of (faces, textures, params, rank, n,
mode): ``band_forward`` and ``band_backward``, which a single process can
run for every rank of a world in turn (``assemble`` puts the bands
together).  ``soft_rasterize_sharded`` wraps them in an autograd Function
with explicit collectives:
  forward   the band, ``all_gather_into_tensor`` over the ``'data'``
            group (the bands concatenated in rank order), the rows put
            back in image order;
  backward  the whole image's incoming gradient (the same on every rank:
            the loss is computed from the replicated image, as in the JAX
            package's global view) cut to the rank's band, the band's
            backward, then ``all_reduce(SUM)`` of the face and texture
            gradients over the ``'data'`` group (the ``psum`` of :221 and
            :237).
``torch.distributed.nn.functional.all_gather`` is not used: its backward
sums the ranks' gradients of the gathered tensor, which counts a loss that
every rank computes once per rank.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable
from torch.distributed.device_mesh import DeviceMesh

from ..ops.softras import cuda_impl, pxf_impl, route, torch_impl
from ..ops.softras.params import SoftRasParams

TILE = cuda_impl.TILE      # the binned route's tile rows (the JAX pxt tile, 16 px)
BAND_MODES = ('stride', 'contig')


def band_row_src(image_size: int, n_dev: int, tile: int):
    """Pixel-row source indices of the strided-band layout.

    Device d owns tile rows d, d + n, d + 2n, ...; the concatenated
    per-device bands therefore hold image row ``src[i]`` at strided row
    ``i``.  Returns (src, inv) with ``strided[i] == image[src[i]]`` and
    ``image[j] == strided[inv[j]]``."""
    TY = image_size // tile
    TYB = TY // n_dev
    src = np.concatenate([
        np.arange(tile) + (d + k * n_dev) * tile
        for d in range(n_dev) for k in range(TYB)])
    inv = np.argsort(src)
    return src, inv


class BandPlan(NamedTuple):
    """How an image is cut into n bands."""
    route: str          # 'binned', 'px_f' or 'plain'
    n: int              # bands
    strided: bool       # tile rows dealt out round-robin
    tile: int           # image rows of a band's unit row
    rows: int           # image rows of a band


def band_plan(p: SoftRasParams, n: int, device, band_mode: str = 'stride') -> BandPlan:
    """The band path of an image of ``p.image_size`` rows over ``n`` ranks,
    for inputs on ``device`` (see the module docstring)."""
    if band_mode not in BAND_MODES:
        raise ValueError(f'band_mode must be one of {BAND_MODES}, got {band_mode!r}')
    is_ = p.image_size
    device = torch.device(device)
    stride = band_mode == 'stride' and n > 1
    if device.type == 'cuda':
        name = route.layout()
        if name not in route.LAYOUTS:
            raise ValueError(f'JR_LAYOUT must be one of {route.LAYOUTS}, got {name!r}')
        if name == 'pxt' and is_ % TILE == 0 and (is_ // TILE) % n == 0:
            return BandPlan('binned', n, stride, TILE, is_ // n)
        t = pxf_impl.tile_for(is_)
        if not t or (is_ // t) % n:
            raise ValueError(f'the px_f tile rows of {is_} px do not divide over {n} ranks')
        return BandPlan('px_f', n, False, t, is_ // n)
    if device.type != 'cpu':
        raise ValueError(f'soft_rasterize_sharded runs on cuda or cpu, not {device}')
    if is_ % n:
        raise ValueError(f'{is_} rows do not divide over {n} ranks')
    if is_ % TILE == 0 and (is_ // TILE) % n == 0:
        return BandPlan('plain', n, stride, TILE, is_ // n)
    return BandPlan('plain', n, False, is_ // n, is_ // n)


def band_of(plan: BandPlan, rank: int) -> tuple[int, int, int]:
    """Rank ``rank``'s band (ty0, ty_band, ty_stride) in the plan's unit
    rows."""
    per = plan.rows // plan.tile
    return (rank, per, plan.n) if plan.strided else (rank * per, per, 1)


def band_image_rows(plan: BandPlan, rank: int) -> torch.Tensor:
    """The image rows of rank ``rank``'s band, in the band's order: [rows]
    int64 on the CPU."""
    return cuda_impl.band_rows(plan.n * plan.rows, band_of(plan, rank), plan.tile)


class BandState(NamedTuple):
    """One band's forward: its maps and what its backward reads."""
    plan: BandPlan
    rank: int
    images: torch.Tensor               # [B, 4, rows, W]
    aggrs: torch.Tensor                # [B, 2, rows, W]
    counts: torch.Tensor               # [B, rows, W] int32
    thr: torch.Tensor | None           # [B, rows, W], None where no truncation binds
    table: object                      # cuda_impl.FwdInputs, tiled.TiledInputs or None


def band_forward(face_vertices: torch.Tensor, textures: torch.Tensor, p: SoftRasParams,
                 rank: int, n: int, band_mode: str = 'stride',
                 need_grad: bool = False) -> BandState:
    """Rank ``rank`` of ``n``: the maps of its band of ``face_vertices``
    [B,F,9] and ``textures``, and, with ``need_grad``, what its backward
    reads (the threshold only where the top-K truncation binds; a forward
    that no gradient can follow skips it, as the JAX package's does,
    :135-140)."""
    plan = band_plan(p, n, face_vertices.device, band_mode)
    if not 0 <= rank < n:
        raise ValueError(f'rank {rank} of {n}')
    band = band_of(plan, rank)
    with_thr = need_grad and torch_impl.use_threshold(p, face_vertices.shape[1])
    table = thr = None
    if plan.route == 'binned':
        table = cuda_impl.prepare(face_vertices, textures, p, for_grad=need_grad, band=band)
        images, aggrs, counts = cuda_impl.launch(table, p)
        if with_thr:
            thr = cuda_impl.launch_thr(table, counts, p)
    elif plan.route == 'px_f':
        table = pxf_impl.prep_pxf(face_vertices, textures, p, band[0], band[1],
                                  for_grad=need_grad)
        images, aggrs, counts, thr = pxf_impl.forward(table, p, with_thr)
    else:
        rows = band_image_rows(plan, rank)
        images, aggrs, counts = torch_impl.forward_rows(face_vertices, textures, p, rows)
        if with_thr:
            thr = torch_impl.threshold_rows(face_vertices, p, rows)
    return BandState(plan, rank, images, aggrs, counts, thr, table)


def band_backward(state: BandState, face_vertices: torch.Tensor, textures: torch.Tensor,
                  grad_band: torch.Tensor, p: SoftRasParams):
    """The gradient of one band's pixels: ``grad_band`` [B,4,rows,W] is the
    incoming gradient of the band's rows.  Returns (grad_face_vertices
    [B,F,9], grad_textures like textures), to be summed over the bands."""
    grad_band = grad_band.contiguous()
    if state.plan.route == 'binned':
        return cuda_impl.soft_rasterize_bwd(face_vertices, textures, state.images,
                                            state.aggrs, state.thr, grad_band, p, state.table)
    if state.plan.route == 'px_f':
        gf, gt = pxf_impl.backward(state.table, state.images, state.aggrs, state.thr,
                                   grad_band, p)
        return gf, gt.reshape(textures.shape)
    return torch_impl.backward_rows(face_vertices, textures, state.images, state.aggrs,
                                    state.thr, grad_band, p,
                                    band_image_rows(state.plan, state.rank))


def assemble(bands: torch.Tensor, plan: BandPlan) -> torch.Tensor:
    """The image from its bands stacked in rank order, [n, B, C, rows, W]
    (``all_gather_into_tensor``'s layout): [B, C, H, W] in image order."""
    n, B, C, Hb, W = bands.shape
    image = bands.permute(1, 2, 0, 3, 4).reshape(B, C, n * Hb, W)
    if plan.strided:
        _, inv = band_row_src(n * Hb, n, plan.tile)
        image = image.index_select(2, torch.from_numpy(inv).to(image.device))
    return image


def _all_gather(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """The ranks' ``x`` concatenated along dim 0 into ``out``, in rank order:
    ``all_gather_into_tensor``, which newer PyTorch names
    ``all_gather_single``."""
    gather = getattr(dist, 'all_gather_single', None) or dist.all_gather_into_tensor
    gather(out, x, group=group)


class ShardedRasterize(torch.autograd.Function):
    """images [B,4,H,W] of face_vertices [B,F,9] and textures, this rank's
    band rendered and the bands gathered over ``group`` (``n`` ranks, this
    one ``rank``); the backward sums the bands' gradients over ``group``."""

    @staticmethod
    def forward(ctx, face_vertices, textures, p: SoftRasParams, group, rank: int, n: int,
                band_mode: str, need_grad: bool):
        state = band_forward(face_vertices, textures, p, rank, n, band_mode, need_grad)
        band = state.images.contiguous()
        bands = band.new_empty((n * band.shape[0],) + tuple(band.shape[1:]))
        _all_gather(bands, band, group)
        if need_grad:
            ctx.p, ctx.group, ctx.state = p, group, state
            ctx.save_for_backward(face_vertices, textures)
        return assemble(bands.reshape((n,) + tuple(band.shape)), state.plan)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_images):
        face_vertices, textures = ctx.saved_tensors
        state = ctx.state
        rows = band_image_rows(state.plan, state.rank).to(grad_images.device)
        grad_face, grad_tex = band_backward(state, face_vertices, textures,
                                            grad_images.index_select(2, rows), ctx.p)
        grad_face, grad_tex = grad_face.contiguous(), grad_tex.contiguous()
        dist.all_reduce(grad_face, op=dist.ReduceOp.SUM, group=ctx.group)
        dist.all_reduce(grad_tex, op=dist.ReduceOp.SUM, group=ctx.group)
        return (grad_face if ctx.needs_input_grad[0] else None,
                grad_tex if ctx.needs_input_grad[1] else None,
                None, None, None, None, None, None)


def soft_rasterize_sharded(face_vertices: torch.Tensor, textures: torch.Tensor,
                           p: SoftRasParams, mesh: DeviceMesh, axis: str = 'data',
                           band_mode: str = 'stride') -> torch.Tensor:
    """Differentiable band-sharded rasterization over the ``axis`` ranks of
    ``mesh``: images [B,4,H,W], the whole image on every rank, equal to
    one card's ``soft_rasterize`` up to the order of the gradients' sums
    over the bands (and bit for bit with one rank).  ``face_vertices``
    [B,F,3,3] or [B,F,9] and ``textures`` (as ``soft_rasterize`` takes
    them) are the same on every rank; their gradients are too."""
    B, F = face_vertices.shape[:2]
    face = face_vertices.reshape(B, F, 9)
    need_grad = torch.is_grad_enabled() and (face.requires_grad or textures.requires_grad)
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    return ShardedRasterize.apply(face, textures, p, mesh.get_group(axis),
                                  mesh.get_local_rank(axis), n, band_mode, need_grad)
