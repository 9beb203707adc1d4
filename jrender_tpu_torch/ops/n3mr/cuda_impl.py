"""N3MR on the card: the kernels' wrappers, and the entry points that go
by their input's device.

Counterpart of ``jrender_tpu/ops/n3mr/pallas_impl.py``
(``forward_sel_pallas`` :240, ``backward_textures_pallas`` :390) and
``banded_bwd.py`` (``backward_pixel_map_banded`` :636), without the TPU's
work items, band lists and caps: every face and every edge is processed.

Kernels and wrappers (each wrapper counts its launches in ``.launches``):
  ``launch_maps``     csrc/n3mr_maps.cu     the z-buffer's maps and, with
                                            textures, the sampled rgb
  ``launch_texbwd``   csrc/n3mr_texbwd.cu   the texture gradient
  ``launch_edgebwd``  csrc/n3mr_edgebwd.cu  the NMR edge gradient

``forward_maps``, ``backward_textures`` and ``backward_pixel_map`` go by
the device of their input: a CPU tensor takes the plain version
(``torch_impl``), a CUDA tensor the kernel.  There is no fallback: a CUDA
input launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..softras import binning
from ..softras.cuda_impl import _check, _entry, _run
from . import torch_impl
from .torch_impl import ROW

TILE = 16                     # screen tile = one block of TILE x TILE threads
MAPS_CHUNK = 128              # face rows staged in shared memory at once


class _MapsArgs(ctypes.Structure):
    """Mirror of ``n3mr::MapsArgs`` in csrc/n3mr_maps.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        'rows', 'tex', 'faces_sorted', 'starts', 'run_counts', 'glist', 'gcount',
        'ranges', 'face_index', 'depth', 'weight', 'face_inv', 'zcorn', 'rgb')] + \
        [(n, ctypes.c_int) for n in (
            'B', 'F', 'L', 'image_size', 'tiles_x', 'tiles_y', 'chunk', 'ts')] + \
        [(n, ctypes.c_float) for n in ('near', 'far', 'eps')]


class _TexBwdArgs(ctypes.Structure):
    """Mirror of ``n3mr::TexBwdArgs`` in csrc/n3mr_texbwd.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        'rows', 'face_index', 'weight', 'depth', 'zcorn', 'grad_rgb', 'grad_tex')] + \
        [(n, ctypes.c_int) for n in ('B', 'F', 'image_size', 'ts')] + \
        [('eps', ctypes.c_float)]


class _EdgeBwdArgs(ctypes.Structure):
    """Mirror of ``n3mr::EdgeBwdArgs`` in csrc/n3mr_edgebwd.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        'pp', 'fi2', 'planes', 'grad_face')] + \
        [(n, ctypes.c_int) for n in (
            'B', 'F', 'image_size', 'nch', 'return_rgb', 'return_alpha')] + \
        [('eps', ctypes.c_float)]


def _device_of(t: torch.Tensor) -> torch.device:
    if t.device.type != 'cuda':
        raise ValueError(f'the CUDA kernel needs CUDA tensors, got {t.device}')
    return t.device


def launch_maps(rows: torch.Tensor, lists: binning.CompactLists, textures,
                is_: int, near: float, far: float, eps: float):
    """Launch the z-buffer kernel on the current stream.

    rows [B,F,19] (``torch_impl.face_rows``), ``lists`` the tile lists of
    the y-negated faces, ``textures`` [B,F,ts,ts,ts,3] or None.  Returns
    (face_index [B,H,W] int32, weight [B,H,W,3], depth [B,H,W], face_inv
    [B,H,W,9], zcorn [B,H,W,3], rgb [B,H,W,3] or None): what
    ``torch_impl.forward_maps`` and ``trilinear_rgb_from_maps`` return.
    Any texture size is served.  ``launch_maps.launches`` counts the
    launches."""
    dev = _device_of(rows)
    if rows.dim() != 3:
        raise ValueError(f'rows must be [B, F, {ROW}], got {tuple(rows.shape)}')
    B, F = rows.shape[:2]
    if B > 65535:
        raise ValueError(f'the kernels take at most 65,535 batch elements, got {B}')
    tiles = -(-is_ // TILE)
    NT = tiles * tiles
    L = lists.faces_sorted.shape[1]
    _check(rows, 'rows', torch.float32, (B, F, ROW), dev)
    _check(lists.faces_sorted, 'faces_sorted', torch.int32, (B, L), dev)
    _check(lists.starts, 'starts', torch.int32, (B, NT), dev)
    _check(lists.run_counts, 'run_counts', torch.int32, (B, NT), dev)
    _check(lists.glist, 'glist', torch.int32, (B, F), dev)
    _check(lists.gcount, 'gcount', torch.int32, (B,), dev)
    _check(lists.ranges, 'ranges', torch.int32, (B, F, 4), dev)
    ts = 0
    if textures is not None:
        ts = textures.shape[2]
        _check(textures, 'textures', torch.float32, (B, F, ts, ts, ts, 3), dev)

    def out(*shape, dtype=torch.float32):
        return torch.empty((B, is_, is_) + shape, dtype=dtype, device=dev)

    fi, depth = out(dtype=torch.int32), out()
    weight, face_inv, zcorn = out(3), out(9), out(3)
    rgb = out(3) if textures is not None else None

    fn = _entry('n3mr_maps', 'n3mr_maps', _MapsArgs)
    args = _MapsArgs(
        rows.data_ptr(), None if textures is None else textures.data_ptr(),
        lists.faces_sorted.data_ptr(), lists.starts.data_ptr(),
        lists.run_counts.data_ptr(), lists.glist.data_ptr(), lists.gcount.data_ptr(),
        lists.ranges.data_ptr(), fi.data_ptr(), depth.data_ptr(), weight.data_ptr(),
        face_inv.data_ptr(), zcorn.data_ptr(), None if rgb is None else rgb.data_ptr(),
        B, F, L, is_, tiles, tiles, MAPS_CHUNK, ts, near, far, eps)
    _run(fn, 'n3mr_maps', args, dev)
    launch_maps.launches += 1
    return fi, weight, depth, face_inv, zcorn, rgb


launch_maps.launches = 0


def launch_texbwd(rows, tex_shape, face_index, weight, depth, zcorn, grad_rgb,
                  eps: float):
    """Launch the texture-gradient kernel on the current stream: grad_tex
    [B,F,ts,ts,ts,3] from the forward's rows [B,F,19] and maps and the rgb
    gradient [B,H,W,3].  Any texture size is served: up to 6 in one walk of
    a face's pixels, a larger one in several.  Deterministic: no atomics,
    every sum in a fixed order.  ``launch_texbwd.launches`` counts the launches."""
    dev = _device_of(rows)
    B, F, ts = tex_shape[:3]
    if ts < 1:
        raise ValueError(f'the texture size must be at least 1, got {ts}')
    is_ = face_index.shape[1]
    _check(rows, 'rows', torch.float32, (B, F, ROW), dev)
    _check(face_index, 'face_index', torch.int32, (B, is_, is_), dev)
    _check(weight, 'weight', torch.float32, (B, is_, is_, 3), dev)
    _check(depth, 'depth', torch.float32, (B, is_, is_), dev)
    _check(zcorn, 'zcorn', torch.float32, (B, is_, is_, 3), dev)
    _check(grad_rgb, 'grad_rgb', torch.float32, (B, is_, is_, 3), dev)
    grad_tex = torch.empty((B, F, ts, ts, ts, 3), dtype=torch.float32, device=dev)

    fn = _entry('n3mr_texbwd', 'n3mr_texbwd', _TexBwdArgs)
    args = _TexBwdArgs(rows.data_ptr(), face_index.data_ptr(), weight.data_ptr(),
                       depth.data_ptr(), zcorn.data_ptr(), grad_rgb.data_ptr(),
                       grad_tex.data_ptr(), B, F, is_, ts, eps)
    _run(fn, 'n3mr_texbwd', args, dev)
    launch_texbwd.launches += 1
    return grad_tex


launch_texbwd.launches = 0


def edge_inputs(face, face_index, rgb_map, alpha_map, grad_rgb, grad_alpha,
                is_: int, return_rgb: bool, return_alpha: bool):
    """What the edge kernel reads, made with plain torch: (pp [B,F,7],
    fi2 [2,B,is,is] int32, planes [2,B,nch,is,is]).

    ``pp`` holds each face's pixel-space xy (x0 y0 x1 y1 x2 y2) and its
    front flag, computed with the plain version's own functions so that
    both sides read the same coordinates.  ``fi2`` and ``planes`` hold the
    maps twice, view 0 transposed (axis 0 scans down columns) and view 1
    as is, so that a warp's lanes read neighbouring addresses on both
    axes.  Channels: alpha and its gradient if ``return_alpha``, then rgb
    and its gradient if ``return_rgb``."""
    B, F = face.shape[:2]
    pp = torch.cat([
        torch_impl._pixel_space(face.reshape(B, F, 3, 3)[..., :2], is_).reshape(B, F, 6),
        torch_impl._face_frontside_n3mr(face).to(face.dtype)[..., None]], dim=-1).contiguous()
    ch = []
    if return_alpha:
        ch += [alpha_map[:, None], grad_alpha[:, None]]
    if return_rgb:
        ch += [rgb_map.permute(0, 3, 1, 2), grad_rgb.permute(0, 3, 1, 2)]
    planes = torch.cat(ch, dim=1)
    return (pp, torch.stack([face_index.transpose(1, 2), face_index]).contiguous(),
            torch.stack([planes.transpose(2, 3), planes]).contiguous())


def launch_edgebwd(pp, fi2, planes, eps: float, return_rgb: bool, return_alpha: bool):
    """Launch the edge-gradient kernel on the current stream: grad_face
    [B,F,9] (x and y columns; z is 0) from ``edge_inputs``.  Deterministic:
    no atomics, every sum in a fixed order.  ``launch_edgebwd.launches``
    counts the launches."""
    dev = _device_of(pp)
    if not (return_rgb or return_alpha):
        raise ValueError('the edge gradient needs return_rgb or return_alpha')
    if pp.dim() != 3 or fi2.dim() != 4:
        raise ValueError(f'pp must be [B, F, 7] and fi2 [2, B, is, is], got '
                         f'{tuple(pp.shape)} and {tuple(fi2.shape)}')
    B, F = pp.shape[:2]
    is_ = fi2.shape[-1]
    nch = (2 if return_alpha else 0) + (6 if return_rgb else 0)
    _check(pp, 'pp', torch.float32, (B, F, 7), dev)
    _check(fi2, 'fi2', torch.int32, (2, B, is_, is_), dev)
    _check(planes, 'planes', torch.float32, (2, B, nch, is_, is_), dev)
    grad_face = torch.empty((B, F, 9), dtype=torch.float32, device=dev)

    fn = _entry('n3mr_edgebwd', 'n3mr_edgebwd', _EdgeBwdArgs)
    args = _EdgeBwdArgs(pp.data_ptr(), fi2.data_ptr(), planes.data_ptr(),
                        grad_face.data_ptr(), B, F, is_, nch,
                        int(return_rgb), int(return_alpha), eps)
    _run(fn, 'n3mr_edgebwd', args, dev)
    launch_edgebwd.launches += 1
    return grad_face


launch_edgebwd.launches = 0


def tile_lists(face: torch.Tensor, is_: int) -> binning.CompactLists:
    """The z-buffer kernel's tile lists.  The binning's rows fall with y,
    n3mr's grow with it (``torch_impl._pixel_coords``), so a y-negated copy
    of the faces is binned: the row extents then line up."""
    neg_y = face * face.new_tensor([1.0, -1.0, 1.0] * 3)
    return binning.build_tile_lists_compact(neg_y, is_, TILE, TILE, 0.0)


def _by_device(t: torch.Tensor) -> bool:
    """True for the card, False for the CPU; raises on anything else."""
    if t.device.type == 'cpu':
        return False
    if t.device.type != 'cuda':
        raise ValueError(f'n3mr runs on cuda or cpu, not {t.device}')
    return True


def forward_maps(face, textures, is_: int, near: float, far: float, eps: float):
    """The z-buffer and the texture fetch of one batch: face [B,F,9],
    ``textures`` [B,F,ts,ts,ts,3] or None.  Returns (rows [B,F,19],
    face_index, weight, depth, face_inv, zcorn, rgb or None); rgb is 0
    where no face was drawn."""
    rows = torch_impl.face_rows(face, is_)
    if _by_device(face):
        return (rows,) + launch_maps(rows, tile_lists(face, is_), textures, is_,
                                     near, far, eps)
    fi, wt, dp, finv, zc = torch_impl.forward_maps(face, is_, near, far)
    rgb = None if textures is None else \
        torch_impl.trilinear_rgb_from_maps(textures, fi, wt, dp, zc, eps)
    return rows, fi, wt, dp, finv, zc, rgb


def backward_textures(rows, tex_shape, face_index, weight, depth, zcorn, grad_rgb,
                      eps: float):
    """Texture gradient [B,F,ts,ts,ts,3], any texture size."""
    if _by_device(face_index):
        return launch_texbwd(rows, tex_shape, face_index, weight, depth, zcorn,
                             grad_rgb, eps)
    return torch_impl.backward_textures(tex_shape, face_index, weight, depth, zcorn,
                                        grad_rgb, eps)


def backward_pixel_map(face, face_index, rgb_map, alpha_map, grad_rgb, grad_alpha,
                       is_: int, eps: float, return_rgb: bool, return_alpha: bool):
    """NMR edge gradient [B,F,9]."""
    if _by_device(face):
        return launch_edgebwd(*edge_inputs(face, face_index, rgb_map, alpha_map, grad_rgb,
                                           grad_alpha, is_, return_rgb, return_alpha),
                              eps, return_rgb, return_alpha)
    return torch_impl.backward_pixel_map(face, face_index, rgb_map, alpha_map,
                                         grad_rgb, grad_alpha, is_, eps,
                                         return_rgb, return_alpha)
