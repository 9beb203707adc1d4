"""SoftRas on the card: per-face row prep and the kernels' wrappers.

Counterpart of ``jrender_tpu/ops/softras/pxt_impl.py``'s
``soft_rasterize_fwd_pxt`` (:717), ``soft_rasterize_bwd_pxt`` (:1049) and
the fused gather of ``prep_pxt`` (:238-241), without the TPU's work items,
tile blocks or per-lane rows: the CUDA kernels read one row per face and
a CSR face list per screen tile from the binning (``binning.py``).

Kernels and wrappers (each wrapper counts its launches in ``.launches``):
  ``launch``         csrc/softras_fwd.cu   image, aggregates, candidate counts
  ``launch_thr``     csrc/softras_thr.cu   the top-K depth threshold per pixel
  ``launch_bwd``     csrc/softras_bwd.cu   gradient rows per (tile, face) pair
                                           and per big face
  ``launch_reduce``  csrc/softras_bwd.cu   the rows summed per face

``soft_rasterize_fwd``, ``topk_threshold`` and ``soft_rasterize_bwd`` go
by the device of their input: a CPU tensor takes the plain version
(``torch_impl``), a CUDA tensor the kernels.  There is no fallback: a
CUDA input launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ... import _build
from . import binning, torch_impl
from . import geometry as G
from .params import SoftRasParams

TILE = 16                     # screen tile = one block of TILE x TILE threads
MAX_CHUNK = 64                # faces staged in shared memory at once
SMEM_BYTES = 48 * 1024        # a block's static shared-memory budget
ROW_BASE = 31                 # face 9, inv 9, sym 9, obt 3, front 1


class _Scalars(ctypes.Structure):
    _fields_ = [('near', ctypes.c_float), ('far', ctypes.c_float),
                ('far_minus_near', ctypes.c_float), ('eps', ctypes.c_float),
                ('sigma', ctypes.c_float), ('gamma', ctypes.c_float),
                ('threshold', ctypes.c_float), ('sq', ctypes.c_float),
                ('bg', ctypes.c_float * 3), ('fill_back', ctypes.c_int),
                ('texture_type', ctypes.c_int), ('tex_res', ctypes.c_int)]


class _FwdArgs(ctypes.Structure):
    """Mirror of ``softras::FwdArgs`` in csrc/softras_fwd.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        'rows', 'faces_sorted', 'starts', 'run_counts', 'glist', 'gcount',
        'ranges', 'image', 'aggrs', 'counts')] + \
        [(n, ctypes.c_int) for n in (
            'B', 'F', 'L', 'row', 'image_size', 'tiles_x', 'tiles_y', 'chunk',
            'dist_func', 'rgb_func', 'alpha_func')] + [('s', _Scalars)]


class _ThrArgs(ctypes.Structure):
    """Mirror of ``softras::ThrArgs`` in csrc/softras_thr.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        'rows', 'faces_sorted', 'starts', 'run_counts', 'glist', 'gcount',
        'ranges', 'counts', 'thr')] + \
        [(n, ctypes.c_int) for n in (
            'B', 'F', 'L', 'row', 'image_size', 'tiles_x', 'tiles_y', 'chunk',
            'dist_func', 'K')] + [('s', _Scalars)]


class _BwdArgs(ctypes.Structure):
    """Mirror of ``softras::BwdArgs`` in csrc/softras_bwd.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        'rows', 'faces_sorted', 'starts', 'run_counts', 'glist', 'gcount',
        'image', 'aggrs', 'grad', 'thr', 'gslots', 'gbig')] + \
        [(n, ctypes.c_int) for n in (
            'B', 'F', 'L', 'row', 'image_size', 'tiles_x', 'tiles_y', 'chunk',
            'GC', 'dist_func', 'rgb_func', 'alpha_func')] + [('s', _Scalars)]


class _ReduceArgs(ctypes.Structure):
    """Mirror of ``softras::ReduceArgs`` in csrc/softras_bwd.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        'gslots', 'gbig', 'gsrc', 'gpos', 'grad_face', 'grad_tex')] + \
        [(n, ctypes.c_int) for n in ('B', 'F', 'L', 'mt', 'GC')]


class FwdInputs(NamedTuple):
    """What the kernels read: per-face rows and the tile lists."""
    rows: torch.Tensor                 # [B, F, 31 + 3T] f32
    lists: binning.CompactLists
    tex_res: int                       # R, T = R * R (1 for vertex colours)


class GradRows(NamedTuple):
    """What the backward kernel hands to the reduction."""
    gslots: torch.Tensor               # [B, L, GC] one row per sorted pair
    gbig: torch.Tensor                 # [B, F, GC] row g: the g-th big face


def face_rows(face: torch.Tensor, textures: torch.Tensor,
              p: SoftRasParams) -> torch.Tensor:
    """[B, F, 31 + 3T] rows: face 9, inv 9, sym 9, obt 3, front 1, tex 3T."""
    B, F = face.shape[:2]
    inv, sym, obt = G.face_info_preprocess(face)
    front = G.check_face_frontside(face).to(face.dtype)[..., None]
    return torch.cat([face, inv, sym, obt, front,
                      textures.reshape(B, F, -1)], dim=-1).contiguous()


def chunk_for(row: int, reserved_bytes: int = 0) -> int:
    """Faces per shared-memory chunk for a row of ``row`` floats and one
    int per face, in a block that also holds ``reserved_bytes`` of its own."""
    return max(1, min(MAX_CHUNK, (SMEM_BYTES - reserved_bytes) // (4 * row + 4)))


def chunk_for_bwd(row: int, tex_sums: int) -> int:
    """Faces per chunk of the backward kernel, whose block also holds the
    tile's pixel maps (11 floats per pixel) and, for surface textures, 3T
    texel sums per warp (``tex_sums`` floats, 0 for vertex colours)."""
    left = SMEM_BYTES - 4 * (11 * TILE * TILE + (TILE * TILE // 32) * tex_sums)
    if left < 4 * row + 4:
        raise ValueError(f'a face row of {row} floats does not fit the backward '
                         f"kernel's shared memory")
    return min(MAX_CHUNK, left // (4 * row + 4))


def prepare(face_vertices: torch.Tensor, textures: torch.Tensor,
            p: SoftRasParams, for_grad: bool = False, tile_h: int = TILE,
            tile_w: int = TILE) -> FwdInputs:
    """Binning (``tile_h`` x ``tile_w`` tiles) and per-face rows for the
    kernels; plain torch on the device.  ``for_grad`` adds the inverse of
    the binning's sort, which the backward's face reduction gathers
    through."""
    B, F = face_vertices.shape[:2]
    face = face_vertices.reshape(B, F, 9)
    if p.texture_type_id == 0:
        T = textures.shape[2]
        R = math.isqrt(T)
        if R * R != T:
            raise ValueError(f'surface textures need T = R*R texels, got T={T}')
    else:
        R = 1
    lists = binning.build_tile_lists_compact(face, p.image_size, tile_h, tile_w,
                                             p.threshold, with_inverse=for_grad)
    return FwdInputs(face_rows(face, textures, p), lists, R)


def _check(t: torch.Tensor, what: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f'{what} is on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise TypeError(f'{what} must be {dtype}, got {t.dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{what} must have shape {tuple(shape)}, got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{what} must be contiguous')


def _entry(source: str, name: str, args_type):
    """The C entry point ``name`` of ``csrc/<source>.cu``, built on first
    use; raises if its argument struct is laid out otherwise than here."""
    lib = _build.load(source)
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.POINTER(args_type), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size = getattr(lib, f'{name}_args_size')
    size.argtypes = []
    size.restype = ctypes.c_int
    if size() != ctypes.sizeof(args_type):
        raise RuntimeError(f'{args_type.__name__[1:]} layout differs between '
                           f'Python and CUDA')
    return fn


def _run(fn, name: str, args, dev) -> None:
    """Call a kernel's entry point on the current stream; raise on a
    refused launch."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(ctypes.byref(args), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f'{name} kernel launch failed: CUDA error {err}')


def _scalars(p: SoftRasParams, R: int) -> _Scalars:
    thr = p.threshold
    return _Scalars(near=p.near, far=p.far, far_minus_near=p.far - p.near,
                    eps=p.eps, sigma=p.sigma_val, gamma=p.gamma_val,
                    threshold=thr, sq=G.border_inflation(thr),
                    bg=(ctypes.c_float * 3)(*p.background_color),
                    fill_back=int(p.fill_back), texture_type=p.texture_type_id,
                    tex_res=R)


def _check_inputs(inputs: FwdInputs, p: SoftRasParams):
    """The checks every kernel shares: rows and tile lists on one card, of
    the types, shapes and layout the kernels index.  Returns
    (device, B, F, row, L, tiles)."""
    rows, cl, R = inputs
    dev = rows.device
    if dev.type != 'cuda':
        raise ValueError(f'the CUDA kernel needs CUDA tensors, got {dev}')
    if rows.dim() != 3:
        raise ValueError(f'rows must be [B, F, row], got {tuple(rows.shape)}')
    B, F, row = rows.shape
    T3 = row - ROW_BASE
    expect = 3 * R * R if p.texture_type_id == 0 else 9
    if T3 != expect:
        raise ValueError(f'rows hold {T3} texture values, expected {expect}')
    if B > 65535:
        raise ValueError(f'the kernels take at most 65,535 batch elements, got {B}')
    tiles = -(-p.image_size // TILE)
    NT = tiles * tiles
    L = cl.faces_sorted.shape[1]
    _check(rows, 'rows', torch.float32, (B, F, row), dev)
    _check(cl.faces_sorted, 'faces_sorted', torch.int32, (B, L), dev)
    _check(cl.starts, 'starts', torch.int32, (B, NT), dev)
    _check(cl.run_counts, 'run_counts', torch.int32, (B, NT), dev)
    _check(cl.glist, 'glist', torch.int32, (B, F), dev)
    _check(cl.gcount, 'gcount', torch.int32, (B,), dev)
    _check(cl.ranges, 'ranges', torch.int32, (B, F, 4), dev)
    return dev, B, F, row, L, tiles


def launch(inputs: FwdInputs, p: SoftRasParams):
    """Launch the CUDA forward kernel on the current stream.

    Returns (images [B,4,H,W], aggrs [B,2,H,W], counts [B,H,W] int32).
    ``launch.launches`` counts the launches.
    """
    dev, B, F, row, L, tiles = _check_inputs(inputs, p)
    rows, cl, R = inputs
    is_ = p.image_size
    images = torch.empty((B, 4, is_, is_), dtype=torch.float32, device=dev)
    aggrs = torch.empty((B, 2, is_, is_), dtype=torch.float32, device=dev)
    counts = torch.empty((B, is_, is_), dtype=torch.int32, device=dev)

    fn = _entry('softras_fwd', 'softras_fwd', _FwdArgs)
    args = _FwdArgs(
        rows.data_ptr(), cl.faces_sorted.data_ptr(), cl.starts.data_ptr(),
        cl.run_counts.data_ptr(), cl.glist.data_ptr(), cl.gcount.data_ptr(),
        cl.ranges.data_ptr(), images.data_ptr(), aggrs.data_ptr(),
        counts.data_ptr(), B, F, L, row, is_, tiles, tiles, chunk_for(row),
        p.dist_func_id, p.rgb_func_id, p.alpha_func_id, _scalars(p, R))
    _run(fn, 'softras_fwd', args, dev)
    launch.launches += 1
    return images, aggrs, counts


launch.launches = 0


def launch_thr(inputs: FwdInputs, counts: torch.Tensor, p: SoftRasParams):
    """Launch the top-K threshold kernel on the current stream: thr
    [B,H,W], the K-th smallest candidate depth of each pixel (K =
    ``p.max_faces_id``) and ``far`` where ``counts`` (the forward's
    candidate count map) is at most K.  ``launch_thr.launches`` counts the
    launches."""
    dev, B, F, row, L, tiles = _check_inputs(inputs, p)
    rows, cl, R = inputs
    is_ = p.image_size
    if p.max_faces_id < 1:
        raise ValueError(f'K must be at least 1, got {p.max_faces_id}')
    _check(counts, 'counts', torch.int32, (B, is_, is_), dev)
    thr = torch.empty((B, is_, is_), dtype=torch.float32, device=dev)

    fn = _entry('softras_thr', 'softras_thr', _ThrArgs)
    args = _ThrArgs(
        rows.data_ptr(), cl.faces_sorted.data_ptr(), cl.starts.data_ptr(),
        cl.run_counts.data_ptr(), cl.glist.data_ptr(), cl.gcount.data_ptr(),
        cl.ranges.data_ptr(), counts.data_ptr(), thr.data_ptr(),
        B, F, L, row, is_, tiles, tiles, chunk_for(ROW_BASE),
        p.dist_func_id, p.max_faces_id, _scalars(p, R))
    _run(fn, 'softras_thr', args, dev)
    launch_thr.launches += 1
    return thr


launch_thr.launches = 0


def _grad_columns(p: SoftRasParams, R: int) -> int:
    """Values of one gradient row: 9 face coordinates and the textures."""
    return 9 + (3 * R * R if p.texture_type_id == 0 else 9)


def launch_bwd(inputs: FwdInputs, images, aggrs, thr, grad_images,
               p: SoftRasParams) -> GradRows:
    """Launch the backward kernels on the current stream: the per-tile
    kernel writes one gradient row per sorted (tile, face) pair, the
    big-face kernel one row per face of the big-face list.  ``thr`` is the
    threshold map or None (no truncation).  ``launch_bwd.launches`` counts
    the calls."""
    dev, B, F, row, L, tiles = _check_inputs(inputs, p)
    rows, cl, R = inputs
    is_ = p.image_size
    _check(images, 'images', torch.float32, (B, 4, is_, is_), dev)
    _check(aggrs, 'aggrs', torch.float32, (B, 2, is_, is_), dev)
    _check(grad_images, 'grad_images', torch.float32, (B, 4, is_, is_), dev)
    if thr is not None:
        _check(thr, 'thr', torch.float32, (B, is_, is_), dev)
    GC = _grad_columns(p, R)
    tex_sums = GC - 9 if p.texture_type_id == 0 else 0
    out = GradRows(torch.empty((B, L, GC), dtype=torch.float32, device=dev),
                   torch.empty((B, F, GC), dtype=torch.float32, device=dev))

    fn = _entry('softras_bwd', 'softras_bwd', _BwdArgs)
    args = _BwdArgs(
        rows.data_ptr(), cl.faces_sorted.data_ptr(), cl.starts.data_ptr(),
        cl.run_counts.data_ptr(), cl.glist.data_ptr(), cl.gcount.data_ptr(),
        images.data_ptr(), aggrs.data_ptr(), grad_images.data_ptr(),
        None if thr is None else thr.data_ptr(), out.gslots.data_ptr(),
        out.gbig.data_ptr(), B, F, L, row, is_, tiles, tiles,
        chunk_for_bwd(row, tex_sums), GC,
        p.dist_func_id, p.rgb_func_id, p.alpha_func_id, _scalars(p, R))
    _run(fn, 'softras_bwd', args, dev)
    launch_bwd.launches += 1
    return out


launch_bwd.launches = 0


def launch_reduce(inputs: FwdInputs, grad_rows: GradRows, p: SoftRasParams):
    """Launch the face reduction on the current stream: each face's rows
    summed in ascending tile order (or its big-face row taken).  Returns
    (grad_face_vertices [B,F,9], grad_textures [B,F,T,3] or [B,F,3,3]).
    ``launch_reduce.launches`` counts the launches."""
    dev, B, F, row, L, tiles = _check_inputs(inputs, p)
    cl, R = inputs.lists, inputs.tex_res
    if cl.gsrc is None or cl.gpos is None:
        raise ValueError('the tile lists lack the inverse of the sort: '
                         'prepare(..., for_grad=True) makes it')
    GC = _grad_columns(p, R)
    if L % F:
        raise ValueError(f'faces_sorted holds {L} pairs, no multiple of {F} faces')
    mt = L // F
    _check(cl.gsrc, 'gsrc', torch.int32, (B, F, mt), dev)
    _check(cl.gpos, 'gpos', torch.int32, (B, F), dev)
    _check(grad_rows.gslots, 'gslots', torch.float32, (B, L, GC), dev)
    _check(grad_rows.gbig, 'gbig', torch.float32, (B, F, GC), dev)
    grad_face = torch.empty((B, F, 9), dtype=torch.float32, device=dev)
    tex_shape = (B, F, R * R, 3) if p.texture_type_id == 0 else (B, F, 3, 3)
    grad_tex = torch.empty(tex_shape, dtype=torch.float32, device=dev)

    fn = _entry('softras_bwd', 'softras_bwd_reduce', _ReduceArgs)
    args = _ReduceArgs(grad_rows.gslots.data_ptr(), grad_rows.gbig.data_ptr(),
                       cl.gsrc.data_ptr(), cl.gpos.data_ptr(),
                       grad_face.data_ptr(), grad_tex.data_ptr(), B, F, L, mt, GC)
    _run(fn, 'softras_bwd_reduce', args, dev)
    launch_reduce.launches += 1
    return grad_face, grad_tex


launch_reduce.launches = 0


def reduce_rows_plain(inputs: FwdInputs, grad_rows: GradRows, p: SoftRasParams):
    """The plain version of the face reduction: gather each face's rows
    through ``gsrc`` and sum them, or take the face's big-face row.
    Returns what ``launch_reduce`` returns."""
    cl, R = inputs.lists, inputs.tex_res
    B, F, mt = cl.gsrc.shape
    gsrc, gpos = cl.gsrc.long(), cl.gpos.long()
    b = torch.arange(B, device=gsrc.device)[:, None]
    rows = grad_rows.gslots[b[..., None], gsrc.clamp_min(0)]        # [B,F,mt,GC]
    total = torch.where((gsrc >= 0)[..., None], rows, 0.0).sum(dim=2)
    total = torch.where((gpos >= 0)[..., None],
                        grad_rows.gbig[b, gpos.clamp_min(0)], total)
    tex_shape = (B, F, R * R, 3) if p.texture_type_id == 0 else (B, F, 3, 3)
    return total[..., :9].contiguous(), total[..., 9:].reshape(tex_shape)


def soft_rasterize_fwd(face_vertices: torch.Tensor, textures: torch.Tensor,
                       p: SoftRasParams):
    """Forward of one batch: face_vertices [B,F,9], textures [B,F,T,3] or
    [B,F,3,3].  Returns (images [B,4,H,W], aggrs [B,2,H,W],
    counts [B,H,W] int32)."""
    dev = face_vertices.device
    if dev.type == 'cpu':
        return torch_impl.soft_rasterize_fwd_plain(face_vertices, textures, p)
    if dev.type != 'cuda':
        raise ValueError(f'soft_rasterize runs on cuda or cpu, not {dev}')
    return launch(prepare(face_vertices, textures, p), p)


def topk_threshold(face_vertices: torch.Tensor, p: SoftRasParams,
                   inputs: FwdInputs | None = None, counts=None):
    """The top-K depth threshold map [B,H,W] that the backward masks with,
    or None where the truncation does not bind (``grad_mode='full'`` or
    K >= F).  On the card it needs the forward's ``inputs`` and candidate
    ``counts``."""
    if not torch_impl.use_threshold(p, face_vertices.shape[1]):
        return None
    dev = face_vertices.device
    if dev.type == 'cpu':
        return torch_impl.topk_threshold_plain(face_vertices, p)
    if dev.type != 'cuda':
        raise ValueError(f'soft_rasterize runs on cuda or cpu, not {dev}')
    return launch_thr(inputs, counts, p)


def soft_rasterize_bwd(face_vertices: torch.Tensor, textures: torch.Tensor,
                       images, aggrs, thr, grad_images, p: SoftRasParams,
                       inputs: FwdInputs | None = None):
    """Backward of one batch: the forward's ``images`` and ``aggrs``, the
    threshold map ``thr`` (or None) and the incoming ``grad_images``
    [B,4,H,W].  Returns (grad_face_vertices [B,F,9], grad_textures like
    textures).  On the card ``inputs`` are the forward's rows and lists,
    made with ``prepare(..., for_grad=True)``: the binning runs once per
    step."""
    dev = face_vertices.device
    if dev.type == 'cpu':
        return torch_impl.soft_rasterize_bwd_plain(
            face_vertices, textures, images, aggrs, thr, grad_images, p)
    if dev.type != 'cuda':
        raise ValueError(f'soft_rasterize runs on cuda or cpu, not {dev}')
    if inputs is None:
        raise ValueError("on the card the backward needs the forward's inputs "
                         '(prepare(..., for_grad=True))')
    grad_rows = launch_bwd(inputs, images, aggrs, thr, grad_images.contiguous(), p)
    grad_face, grad_tex = launch_reduce(inputs, grad_rows, p)
    return grad_face, grad_tex.reshape(textures.shape)
