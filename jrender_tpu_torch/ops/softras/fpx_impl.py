"""SoftRas over wide tiles with an untruncated backward: the ``f_px`` route.

Counterpart of the ``f_px`` part of ``jrender_tpu/ops/softras/pallas_impl.py``:
``_tile_cap`` / ``_work_cap`` (:683-697), ``_prep_work_data`` (:699),
``soft_rasterize_fwd_pallas`` (:759, kernel ``_make_fwd_kernel`` :313) and
``soft_rasterize_bwd_pallas`` (:612, kernel ``_make_bwd_kernel`` :442 with
its segment sum :670-678), taken where ``JR_LAYOUT=f_px`` (``route.py``).

Tiles are 16 x min(128, is) pixels and the route runs only where they
divide the image (``runs``; the JAX forward asserts elsewhere, :765).  The
lists are the binning's at that tile shape (``tiled.prep``), cut into work
items of at most 32 faces for the backward.  **No caps**: the JAX package
caps a tile's list at 4,096 faces and sizes its grid for the worst case
(``_tile_cap``, ``_work_cap``); the port keeps every face and makes exactly
the items the lists need, so neither has a counterpart.

The forward computes no top-K threshold and the backward is the
reference's untruncated one (pallas_impl.py:12-16): every candidate pair
sends gradient.  ``route.route`` therefore gives this route no call where
the truncation binds (a gradient with ``grad_mode='topk'`` and K < F goes
to the binned route, as the JAX package goes to its oracle), and
``forward`` / ``backward`` refuse a threshold.

Kernels and wrappers (each wrapper counts its launches in ``.launches``):
  ``launch_fpx_fwd``  csrc/softras_fpx_fwd.cu  image, aggregates, counts
  ``launch_fpx_bwd``  csrc/softras_fpx_bwd.cu  one gradient row per entry
The face sum after the backward is ``tiled.face_sum`` (the segment sum).

The plain versions are ``tiled``'s (``fwd_plain``, ``bwd_rows_plain``,
``sum_plain``).  ``forward`` and ``backward`` go by the device of their
input (``tiled.forward`` / ``tiled.backward``): a CPU tensor takes the
plain versions, a CUDA tensor the kernels, with no fallback.
"""
from __future__ import annotations

from . import tiled
from .params import SoftRasParams
from .tiled import TiledInputs

TILE_H = 16       # tile rows
TILE_W = 128      # tile columns at most
GROUP = 32        # faces of a backward work item at most (the JAX FACE_BLOCK)


def tile_shape(image_size: int) -> tuple[int, int]:
    """(rows, columns) of a tile: 16 x min(128, is)."""
    return TILE_H, min(TILE_W, image_size)


def runs(image_size: int) -> bool:
    """Whether the route's tiles divide the image (pallas_impl.py:763-765)."""
    th, tw = tile_shape(image_size)
    return image_size % th == 0 and image_size % tw == 0


def prep_fpx(face_vertices, textures, p: SoftRasParams, for_grad: bool = False) -> TiledInputs:
    """Rows, tile lists and work items of the f_px route, plain torch on the
    device of the input.  ``for_grad`` adds each face's entries, which the
    backward's face sum walks."""
    if not runs(p.image_size):
        raise ValueError(f'f_px tiles of {tile_shape(p.image_size)} do not divide '
                         f'{p.image_size} px')
    th, tw = tile_shape(p.image_size)
    return tiled.prep(face_vertices, textures, p, th, tw, GROUP, for_grad)


def _untruncated(with_thr: bool):
    if with_thr:
        raise ValueError('the f_px route has no top-K threshold: a binding truncation '
                         'takes the binned route')


def launch_fpx_fwd(pin: TiledInputs, p: SoftRasParams, with_thr: bool = False):
    """Launch the forward kernel on the current stream: each tile's list
    split over a cluster of ``tiled.TILE_SPLIT`` blocks.  Returns (images [B,4,H,W], aggrs [B,2,H,W],
    counts [B,H,W] int32, None).  ``launch_fpx_fwd.launches`` counts the
    launches."""
    _untruncated(with_thr)
    out = tiled.launch_fwd('softras_fpx_fwd', pin, p, False)
    launch_fpx_fwd.launches += 1
    return out


launch_fpx_fwd.launches = 0


def launch_fpx_bwd(pin: TiledInputs, images, aggrs, thr, grad_images, p: SoftRasParams):
    """Launch the backward kernel on the current stream: a block per work
    item, every candidate sending gradient (``thr`` must be None).  Returns
    rows [E, GC].  ``launch_fpx_bwd.launches`` counts the launches."""
    if thr is not None:
        raise ValueError('the f_px backward is untruncated and takes no threshold')
    grows = tiled.launch_bwd('softras_fpx_bwd', pin, images, aggrs, None, grad_images, p)
    launch_fpx_bwd.launches += 1
    return grows


launch_fpx_bwd.launches = 0


def forward(pin: TiledInputs, p: SoftRasParams, with_thr: bool = False):
    """(images, aggrs, counts, None) of the f_px route, by device."""
    _untruncated(with_thr)
    return tiled.forward(pin, p, False, launch_fpx_fwd)


def backward(pin: TiledInputs, images, aggrs, thr, grad_images, p: SoftRasParams):
    """(grad_face_vertices [B,F,9], grad_textures) of the f_px route, by
    device; untruncated, so ``thr`` must be None."""
    if thr is not None:
        raise ValueError('the f_px backward is untruncated and takes no threshold')
    return tiled.backward(pin, images, aggrs, None, grad_images, p, launch_fpx_bwd)
