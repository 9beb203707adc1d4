"""SoftRas over small square tiles, by bands of tile rows: the ``px_f`` route.

Counterpart of the ``px_f`` part of ``jrender_tpu/ops/softras/pallas_impl.py``:
``_pf_tile_for`` (:869), ``_thr_bisect_bounds`` (:876), ``_work_gather_pf``
(:1361), ``_prep_work_data_pf`` (:1423), ``prep_pf`` (:1486),
``soft_rasterize_fwd_pallas_pf`` (:1532, kernel ``_make_fwd_kernel_pf``
:894, with the fill of uncovered tiles :1610-1624) and
``soft_rasterize_bwd_pallas_pf`` (:1631, kernel ``_make_bwd_kernel_pf``
:1161, with its segment sum :1713-1724), taken where ``JR_LAYOUT=px_f``
(``route.py``).

Tiles are t x t pixels, t = 32, 16 or 8, the first that divides the image
(``tile_for``; the JAX package's ``JR_PF_TILE`` knob, which may prefer
another, has no counterpart, nor has ``JR_PRECISION``: the port sums in
float32).  The lists are the binning's at that tile (``tiled.prep``),
written once per step and kept for the backward, and cut into work items
of at most 128 faces for it.  **No caps**: the JAX package caps a tile's
list at 2,048 faces, its big-face list at ``binning.CL_GBIG`` and its grid
at ``_work_cap_pf``; the port keeps every face.

Bands.  ``prep_pxf(..., ty0, ty_band)`` keeps the tile rows [ty0, ty0 +
ty_band), as ``prep_pf`` does for pixel-band sharding
(``jrender_tpu/parallel/render.py:154,219``): the forward renders those
rows only, into maps of ty_band * t rows, with pixel centres of the global
rows, and the backward takes the band's maps and returns the gradient of
the band's pixels, which the caller sums over bands.

The forward returns, besides the image and aggregates, the candidate
count and, with ``with_thr``, the top-K threshold (the K-th smallest
candidate depth; ``far`` where a pixel has at most K candidates, as on the
binned route).  The backward masks with ``zp <= thr`` where ``thr`` is
given (the truncation binds) and sends every candidate's gradient
otherwise.

Kernels and wrappers (each wrapper counts its launches in ``.launches``):
  ``launch_pxf_fwd``  csrc/softras_pxf_fwd.cu  image, aggregates, counts,
                                               threshold (a list per pixel
                                               for K <= 32, bisection above)
  ``launch_pxf_bwd``  csrc/softras_pxf_bwd.cu  one gradient row per entry
The face sum after the backward is ``tiled.face_sum`` (the segment sum).

The plain versions are ``tiled``'s (``fwd_plain``, ``bwd_rows_plain``,
``sum_plain``).  ``forward`` and ``backward`` go by the device of their
input (``tiled.forward`` / ``tiled.backward``), with no fallback.
"""
from __future__ import annotations

from . import tiled
from .params import SoftRasParams
from .tiled import TiledInputs

TILES = (32, 16, 8)   # tile edges, the first that divides the image is taken
GROUP = 128           # faces of a backward work item at most (the JAX PF_FB)


def tile_for(image_size: int) -> int:
    """The tile edge for this size, or 0 where none divides it."""
    for t in TILES:
        if image_size % t == 0:
            return t
    return 0


def thr_bisect_bounds(near: float, far: float) -> tuple[int, int, int]:
    """(lo, hi, steps) of the threshold's bisection: the order-preserving
    keys of near and far (``tiled.depth_key``) and enough steps to close
    the range.  Every candidate depth lies in [near, far], so the K-th
    smallest lies between the two keys."""
    lo, hi = tiled.depth_key(near), tiled.depth_key(far)
    return lo, hi, max(1, (hi - lo).bit_length())


def prep_pxf(face_vertices, textures, p: SoftRasParams, ty0: int | None = None,
             ty_band: int | None = None, for_grad: bool = False) -> TiledInputs:
    """Rows, tile lists and work items of the px_f route, plain torch on the
    device of the input; with ``ty0`` and ``ty_band`` those of one band of
    tile rows.  ``for_grad`` adds each face's entries, which the backward's
    face sum walks."""
    t = tile_for(p.image_size)
    if not t:
        raise ValueError(f'no px_f tile of {TILES} divides {p.image_size} px')
    if (ty0 is None) != (ty_band is None):
        raise ValueError('a band needs both ty0 and ty_band')
    band = None if ty0 is None else (int(ty0), int(ty_band))
    return tiled.prep(face_vertices, textures, p, t, t, GROUP, for_grad, band)


def launch_pxf_fwd(pin: TiledInputs, p: SoftRasParams, with_thr: bool):
    """Launch the forward kernel on the current stream: a block per tile of
    the band walks its whole list.  Returns (images [B,4,Hb,W], aggrs
    [B,2,Hb,W], counts [B,Hb,W] int32, thr [B,Hb,W] or None).
    ``launch_pxf_fwd.launches`` counts the launches."""
    out = tiled.launch_fwd('softras_pxf_fwd', pin, p, with_thr,
                           thr_bisect_bounds(p.near, p.far))
    launch_pxf_fwd.launches += 1
    return out


launch_pxf_fwd.launches = 0


def launch_pxf_bwd(pin: TiledInputs, images, aggrs, thr, grad_images, p: SoftRasParams):
    """Launch the backward kernel on the current stream: a block per work
    item of the band; ``thr`` is the band's threshold map or None (no
    truncation).  Returns rows [E, GC].  ``launch_pxf_bwd.launches``
    counts the launches."""
    grows = tiled.launch_bwd('softras_pxf_bwd', pin, images, aggrs, thr, grad_images, p)
    launch_pxf_bwd.launches += 1
    return grows


launch_pxf_bwd.launches = 0


def forward(pin: TiledInputs, p: SoftRasParams, with_thr: bool):
    """(images, aggrs, counts, thr or None) of the px_f route, by device."""
    return tiled.forward(pin, p, with_thr, launch_pxf_fwd)


def backward(pin: TiledInputs, images, aggrs, thr, grad_images, p: SoftRasParams):
    """(grad_face_vertices [B,F,9], grad_textures) of the px_f route, by
    device: the gradient of the band's pixels."""
    return tiled.backward(pin, images, aggrs, thr, grad_images, p, launch_pxf_bwd)
