"""SoftRas without binning, for small meshes: the ``dir`` route.

Counterpart of ``jrender_tpu/ops/softras/dir_impl.py`` (``dir_max_faces``
:64, ``_dir_tile`` :74, ``prep_dir`` :99, ``soft_rasterize_fwd_dir`` :405,
``soft_rasterize_bwd_dir`` :684).  SoftRas has three routes, which
``route.py`` chooses as the JAX package's ``_pallas_route`` (api.py:49-75)
chooses its layouts: this one, ``dir``; ``pxg`` (``pxg_impl``, under
``JR_LAYOUT=pxg``); and the binned one (``cuda_impl``).  Under the default
layout a mesh of at most ``JR_DIR_MAX`` faces (default 0: the route is off,
as in the JAX package) on an image size divisible by 16 or 8 skips the
binning: each
screen tile walks the whole face table, culled face by face with the
faces' bboxes, in Morton order of their bbox centres; the forward finds
the top-K threshold in the same walk; the backward sums each face's
gradient over the pixels of its bbox.  The variable is read at call time.

``JR_DIR_TILE`` and ``JR_DIR_SORT`` are knobs of the TPU layout (the tile
of its grid step, and turning the Morton order off) and have no
counterpart: the CUDA kernels use 16 x 16 pixel blocks at any size, and
the faces are always in Morton order.  The order matters for speed only;
the original ids ride along, so results do not depend on it.

Kernels and wrappers (each wrapper counts its launches in ``.launches``):
  ``launch_dir_fwd``  csrc/softras_dir_fwd.cu  image, aggregates, candidate
                                               counts and, when asked, the
                                               top-K threshold
  ``launch_dir_bwd``  csrc/softras_dir_bwd.cu  face and texture gradients,
                                               in the faces' original order

``forward`` and ``backward`` go by the device of their input: a CPU tensor
takes the plain version (``fwd_plain``, ``bwd_plain``, built on
``torch_impl``), a CUDA tensor the kernel.  There is no fallback: a CUDA
input launches the kernel or raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
import os
from typing import NamedTuple

import torch

from . import cuda_impl, torch_impl
from .cuda_impl import ROW_BASE, SMEM_BYTES, _Scalars, _check, _entry, _run, _scalars
from .geometry import border_inflation
from .params import SoftRasParams

MAX_SPLITS = 64        # most backward warps that share one face
SPLIT_PIXELS = 1 << 14  # image pixels per backward warp of a screen-filling face


def dir_max_faces() -> int:
    """Largest face count routed to ``dir``: ``JR_DIR_MAX``, default 0 (off)."""
    return int(os.environ.get('JR_DIR_MAX', '0'))


@contextlib.contextmanager
def with_dir_max(max_faces: int):
    """``JR_DIR_MAX`` set to ``max_faces`` inside the block (0: the route
    is off), restored after it."""
    saved = os.environ.get('JR_DIR_MAX')
    os.environ['JR_DIR_MAX'] = str(max_faces)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop('JR_DIR_MAX', None)
        else:
            os.environ['JR_DIR_MAX'] = saved


def dir_tile(image_size: int) -> int:
    """The JAX layout's tile for this size, 16 or 8, or 0 where neither
    divides it (then the route is not taken)."""
    for t in (16, 8):
        if image_size % t == 0:
            return t
    return 0


class DirInputs(NamedTuple):
    """What the dir kernels read: the face table in Morton order."""
    rows: torch.Tensor      # [B, F, 31 + 3T] f32 face rows (cuda_impl.face_rows), Morton order
    bbox: torch.Tensor      # [B, F, 4] f32 xmin, xmax, ymin, ymax, inflated by sqrt(threshold)
    ids: torch.Tensor       # [B, F] i32 original id of the face at each place
    inv: torch.Tensor       # [B, F] i32 place of each original face
    tex_res: int            # R, T = R * R (1 for vertex colours)


def morton16(qx: torch.Tensor, qy: torch.Tensor) -> torch.Tensor:
    """Interleave two 4-bit coordinates into an 8-bit Morton code (x in the
    even bits), the JAX package's ``_morton16`` in a few whole-tensor ops."""
    def spread(v):                      # 0000abcd -> 0a0b0c0d
        v = (v | (v << 2)) & 0x33
        return (v | (v << 1)) & 0x55
    return spread(qx) | (spread(qy) << 1)


def prep_dir(face_vertices: torch.Tensor, textures: torch.Tensor,
             p: SoftRasParams) -> DirInputs:
    """The face table of the dir route, plain torch on the device of the
    input: bboxes inflated by sqrt(threshold), the stable Morton order of
    their centres on a 16 x 16 grid (the index breaks ties), the per-face
    rows in that order and the permutation both ways.  The order equals
    ``prep_dir``'s of the JAX package, which sorts only above 128 faces;
    here every mesh is sorted.  The inflation is the border test's own
    float32 sqrt (``border_inflation``), so that the kernels' bbox cull and
    their pair test agree to the bit; the JAX package's float64 sqrt can be
    one ulp away from it."""
    B, F = face_vertices.shape[:2]
    dev = face_vertices.device
    face = face_vertices.reshape(B, F, 9)
    if p.texture_type_id == 0:
        T = textures.shape[2]
        R = math.isqrt(T)
        if R * R != T:
            raise ValueError(f'surface textures need T = R*R texels, got T={T}')
    else:
        R = 1
    sq = border_inflation(p.threshold)
    xs, ys = face[..., 0::3], face[..., 1::3]
    bbox = torch.stack([xs.amin(-1) - sq, xs.amax(-1) + sq,
                        ys.amin(-1) - sq, ys.amax(-1) + sq], dim=-1)
    cx = (bbox[..., 0] + bbox[..., 1]) * 0.5
    cy = (bbox[..., 2] + bbox[..., 3]) * 0.5

    def cell(c):
        return torch.nan_to_num((c + 1.0) * 8.0, nan=0.0).clamp(0, 15).to(torch.int32)

    order = torch.argsort(morton16(cell(cx), cell(cy)), dim=1, stable=True)   # [B, F]
    inv = torch.empty_like(order)
    inv.scatter_(1, order, torch.arange(F, device=dev).expand(B, F))
    rows = cuda_impl.face_rows(face.gather(1, order[..., None].expand(B, F, 9)),
                               textures.reshape(B, F, -1).gather(
                                   1, order[..., None].expand(B, F, textures[0, 0].numel())), p)
    return DirInputs(rows, bbox.gather(1, order[..., None].expand(B, F, 4)).contiguous(),
                     order.to(torch.int32), inv.to(torch.int32), R)


def table_faces(inputs: DirInputs, p: SoftRasParams):
    """(face [B,F,9], textures [B,F,T,3] or [B,F,3,3]) of the Morton table."""
    rows = inputs.rows
    B, F = rows.shape[:2]
    tex = rows[..., ROW_BASE:]
    tex = tex.reshape(B, F, -1, 3) if p.texture_type_id == 0 else tex.reshape(B, F, 3, 3)
    return rows[..., :9], tex


def _tex_shape(p: SoftRasParams, B: int, F: int, R: int):
    return (B, F, R * R, 3) if p.texture_type_id == 0 else (B, F, 3, 3)


# --------------------------------------------------------------------------
# the plain versions
# --------------------------------------------------------------------------

def fwd_plain(inputs: DirInputs, p: SoftRasParams, with_thr: bool,
              chunk_pairs: int = torch_impl.CHUNK_PAIRS):
    """The plain version of the forward kernel: the Morton table and original
    ids in, pixel-order maps out.  The bboxes, which the kernel culls with,
    change no result of a finite face: their test is the pair's own border
    test (a NaN face, which the kernels cull, poisons the plain versions, as
    on the binned route).  Returns (images [B,4,H,W], aggrs
    [B,2,H,W], counts [B,H,W] int32, thr [B,H,W] or None); the hard
    z-buffer breaks depth ties by the lowest original id and reports it."""
    face, tex = table_faces(inputs, p)
    B = face.shape[0]
    is_ = p.image_size
    xp, yp = torch_impl.pixel_grid(is_, face.device)
    col, ag, cnt = torch_impl.forward_pixels(face, tex, p, xp, yp, chunk_pairs,
                                             ids=inputs.ids)
    thr = None
    if with_thr:
        thr = torch_impl.topk_threshold(face, p, xp, yp, chunk_pairs).reshape(B, is_, is_)
    return (col.permute(0, 2, 1).reshape(B, 4, is_, is_),
            ag.permute(0, 2, 1).reshape(B, 2, is_, is_), cnt.reshape(B, is_, is_), thr)


def bwd_plain(inputs: DirInputs, images, aggrs, thr, grad_images, p: SoftRasParams,
              chunk_pairs: int = torch_impl.CHUNK_PAIRS // 4):
    """The plain version of the backward kernel: gradients summed at the
    Morton places, then un-permuted through ``inv``.  Returns
    (grad_face_vertices [B,F,9], grad_textures [B,F,T,3] or [B,F,3,3]) in
    the original order."""
    face, tex = table_faces(inputs, p)
    B, F = face.shape[:2]
    xp, yp = torch_impl.pixel_grid(p.image_size, face.device)

    def flat(x):
        return x.reshape(B, x.shape[1], -1).permute(0, 2, 1)

    gf, gt = torch_impl.backward_pixels(
        face, tex, flat(images), flat(aggrs), flat(grad_images), p, xp, yp,
        None if thr is None else thr.reshape(B, -1), chunk_pairs=chunk_pairs,
        ids=inputs.ids)
    back = inputs.inv.long()
    return (gf.gather(1, back[..., None].expand_as(gf)),
            gt.gather(1, back[..., None, None].expand_as(gt)))


# --------------------------------------------------------------------------
# the kernels' wrappers
# --------------------------------------------------------------------------

class _DirFwdArgs(ctypes.Structure):
    """Mirror of ``softras::DirFwdArgs`` in csrc/softras_dir_fwd.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        'rows', 'bbox', 'ids', 'image', 'aggrs', 'counts', 'thr')] + \
        [(n, ctypes.c_int) for n in (
            'B', 'F', 'row', 'image_size', 'tiles', 'chunk', 'K',
            'dist_func', 'rgb_func', 'alpha_func')] + [('s', _Scalars)]


class _DirBwdArgs(ctypes.Structure):
    """Mirror of ``softras::DirBwdArgs`` in csrc/softras_dir_bwd.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        'rows', 'bbox', 'ids', 'image', 'aggrs', 'grad', 'thr', 'part',
        'grad_face', 'grad_tex')] + \
        [(n, ctypes.c_int) for n in (
            'B', 'F', 'row', 'image_size', 'splits', 'GC',
            'dist_func', 'rgb_func', 'alpha_func')] + [('s', _Scalars)]


FWD_RESERVED_BYTES = 4 * (256 + 8)   # the forward block's list of 256 face places, 8 warp counts


def _check_inputs(inputs: DirInputs, p: SoftRasParams):
    """Table, bboxes and ids on one card, of the types, shapes and layout the
    kernels index.  Returns (device, B, F, row)."""
    rows = inputs.rows
    dev = rows.device
    if dev.type != 'cuda':
        raise ValueError(f'the CUDA kernel needs CUDA tensors, got {dev}')
    if rows.dim() != 3:
        raise ValueError(f'rows must be [B, F, row], got {tuple(rows.shape)}')
    B, F, row = rows.shape
    R = inputs.tex_res
    expect = 3 * R * R if p.texture_type_id == 0 else 9
    if row - ROW_BASE != expect:
        raise ValueError(f'rows hold {row - ROW_BASE} texture values, expected {expect}')
    if not 1 <= B <= 65535:
        raise ValueError(f'the kernels take 1 to 65,535 batch elements, got {B}')
    if not dir_tile(p.image_size):
        raise ValueError(f'the dir route takes sizes divisible by 8, got {p.image_size}')
    _check(rows, 'rows', torch.float32, (B, F, row), dev)
    _check(inputs.bbox, 'bbox', torch.float32, (B, F, 4), dev)
    _check(inputs.ids, 'ids', torch.int32, (B, F), dev)
    return dev, B, F, row


def launch_dir_fwd(inputs: DirInputs, p: SoftRasParams, with_thr: bool):
    """Launch the dir forward kernel on the current stream.  Returns
    (images [B,4,H,W], aggrs [B,2,H,W], counts [B,H,W] int32, thr [B,H,W] or
    None); the threshold, the K-th smallest candidate depth (K =
    ``p.max_faces_id``) and ``far`` where a pixel has at most K candidates,
    comes from the same walk when ``with_thr``.  ``launch_dir_fwd.launches``
    counts the launches."""
    dev, B, F, row = _check_inputs(inputs, p)
    if with_thr and p.max_faces_id < 1:
        raise ValueError(f'K must be at least 1, got {p.max_faces_id}')
    is_ = p.image_size
    images = torch.empty((B, 4, is_, is_), dtype=torch.float32, device=dev)
    aggrs = torch.empty((B, 2, is_, is_), dtype=torch.float32, device=dev)
    counts = torch.empty((B, is_, is_), dtype=torch.int32, device=dev)
    thr = torch.empty((B, is_, is_), dtype=torch.float32, device=dev) if with_thr else None

    fn = _entry('softras_dir_fwd', 'softras_dir_fwd', _DirFwdArgs)
    args = _DirFwdArgs(
        inputs.rows.data_ptr(), inputs.bbox.data_ptr(), inputs.ids.data_ptr(),
        images.data_ptr(), aggrs.data_ptr(), counts.data_ptr(),
        None if thr is None else thr.data_ptr(), B, F, row, is_,
        -(-is_ // cuda_impl.TILE), cuda_impl.chunk_for(row, FWD_RESERVED_BYTES),
        p.max_faces_id if with_thr else 0,
        p.dist_func_id, p.rgb_func_id, p.alpha_func_id, _scalars(p, inputs.tex_res))
    _run(fn, 'softras_dir_fwd', args, dev)
    launch_dir_fwd.launches += 1
    return images, aggrs, counts, thr


launch_dir_fwd.launches = 0


def launch_dir_bwd(inputs: DirInputs, images, aggrs, thr, grad_images, p: SoftRasParams):
    """Launch the dir backward on the current stream: the pixels of each
    face's bbox, in chunks of 32, are dealt round-robin to ``splits`` warps
    (one per SPLIT_PIXELS of the image, 1 to MAX_SPLITS), each of which
    sums its pixels into a partial row; a
    warp per face sums its partial rows in ascending order and writes the
    face's original row.  ``thr`` is the threshold map or None (no
    truncation).  Returns (grad_face_vertices [B,F,9], grad_textures
    [B,F,T,3] or [B,F,3,3]).  ``launch_dir_bwd.launches`` counts the calls."""
    dev, B, F, row = _check_inputs(inputs, p)
    is_ = p.image_size
    _check(images, 'images', torch.float32, (B, 4, is_, is_), dev)
    _check(aggrs, 'aggrs', torch.float32, (B, 2, is_, is_), dev)
    _check(grad_images, 'grad_images', torch.float32, (B, 4, is_, is_), dev)
    if thr is not None:
        _check(thr, 'thr', torch.float32, (B, is_, is_), dev)
    R = inputs.tex_res
    GC = cuda_impl._grad_columns(p, R)
    T3 = GC - 9 if p.texture_type_id == 0 else 0
    if 4 * 8 * (row + T3) > SMEM_BYTES:
        raise ValueError(f"{T3} texture values per face do not fit the dir backward "
                         f"kernel's shared memory")
    splits = max(1, min(is_ * is_ // SPLIT_PIXELS, MAX_SPLITS))
    part = torch.empty((B, F, splits, GC), dtype=torch.float32, device=dev)
    grad_face = torch.empty((B, F, 9), dtype=torch.float32, device=dev)
    grad_tex = torch.empty(_tex_shape(p, B, F, R), dtype=torch.float32, device=dev)

    fn = _entry('softras_dir_bwd', 'softras_dir_bwd', _DirBwdArgs)
    args = _DirBwdArgs(
        inputs.rows.data_ptr(), inputs.bbox.data_ptr(), inputs.ids.data_ptr(),
        images.data_ptr(), aggrs.data_ptr(), grad_images.data_ptr(),
        None if thr is None else thr.data_ptr(), part.data_ptr(), grad_face.data_ptr(),
        grad_tex.data_ptr(), B, F, row, is_, splits, GC,
        p.dist_func_id, p.rgb_func_id, p.alpha_func_id, _scalars(p, R))
    _run(fn, 'softras_dir_bwd', args, dev)
    launch_dir_bwd.launches += 1
    return grad_face, grad_tex


launch_dir_bwd.launches = 0


# --------------------------------------------------------------------------
# by device
# --------------------------------------------------------------------------

def forward(inputs: DirInputs, p: SoftRasParams, with_thr: bool):
    """(images, aggrs, counts, thr or None) of the dir route: the kernel for
    a CUDA table, the plain version for a CPU one."""
    dev = inputs.rows.device
    if dev.type == 'cpu':
        return fwd_plain(inputs, p, with_thr)
    if dev.type != 'cuda':
        raise ValueError(f'soft_rasterize runs on cuda or cpu, not {dev}')
    return launch_dir_fwd(inputs, p, with_thr)


def backward(inputs: DirInputs, images, aggrs, thr, grad_images, p: SoftRasParams):
    """(grad_face_vertices [B,F,9], grad_textures) of the dir route, by device."""
    dev = inputs.rows.device
    if dev.type == 'cpu':
        return bwd_plain(inputs, images, aggrs, thr, grad_images, p)
    if dev.type != 'cuda':
        raise ValueError(f'soft_rasterize runs on cuda or cpu, not {dev}')
    return launch_dir_bwd(inputs, images, aggrs, thr, grad_images.contiguous(), p)
