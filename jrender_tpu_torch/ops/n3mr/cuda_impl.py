"""N3MR on the card: the kernels' wrappers, and the entry points that go
by their input's device.

Counterpart of ``jrender_tpu/ops/n3mr/pallas_impl.py``
(``forward_sel_pallas`` :240, ``backward_textures_pallas`` :390) and
``banded_bwd.py`` (``backward_pixel_map_banded`` :636), without the TPU's
work items and caps: every face and every edge is processed.

Kernels and wrappers (each wrapper counts its launches in ``.launches``):
  ``launch_maps``        csrc/n3mr_maps.cu     the z-buffer's maps and, with
                                               textures, the sampled rgb; a
                                               cluster of MAPS_SPLIT blocks a
                                               tile (``maps_split_plain`` is
                                               the plain rule of the split)
  ``launch_texbwd``      csrc/n3mr_texbwd.cu   the texture gradient
  ``launch_edge_bands``  csrc/n3mr_edgebwd.cu  the edge items' band keys
  ``launch_edgebwd``     csrc/n3mr_edgebwd.cu  the NMR edge gradient, on the
                                               bands of EDGE_BAND rows that
                                               ``edge_bands`` lists

The edge gradient's items (face, edge, axis) are listed by the bands of
d0 rows their edges span, as ``banded_bwd.build_band_lists`` (:56) lists
them, without its caps: an item over more than EDGE_SPAN bands goes to a
global list.  ``edgebwd_bands_plain`` is the plain version of that
decomposition: partial sums per (item, band) from the lists, added in
ascending band order.

``forward_maps``, ``backward_textures`` and ``backward_pixel_map`` go by
the device of their input: a CPU tensor takes the plain version
(``torch_impl``), a CUDA tensor the kernel.  There is no fallback: a CUDA
input launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ... import _build
from ..._device import device_constant
from ...utils.profiling import annotate
from ..softras import binning
from ..softras import cuda_impl as softras_cuda
from ..softras.cuda_impl import _c_int, _check, _entry, _run
from . import torch_impl
from .torch_impl import ROW

TILE = 16                     # screen tile = one block of TILE x TILE threads
MAPS_CHUNK = 128              # face ids a staged chunk of the z-buffer (kChunk)
MAPS_SPLIT = 4                # tiles (and blocks) a cluster pools (N3MR_MAPS_SPLIT)
# The z-buffer's builds that the card's checks hold bit-equal to the default
# one, named by one digit (``maps_defines``): the tiles a cluster pools.  The
# default build is MAPS_BUILD.
MAPS_BUILD = '4'
MAPS_BUILDS = ('1', '2', '4', '8')
EDGE_BAND = 4                 # d0 rows of an edge band (kBand of csrc/n3mr_edgebwd.cu)
EDGE_SPAN = 8                 # bands an edge item is listed in, at most (kSpan)
EDGE_SMEM_BYTES = 112 * 1024  # a band's staged rows: two blocks an SM


class _MapsArgs(ctypes.Structure):
    """Mirror of ``n3mr::MapsArgs`` in csrc/n3mr_maps.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        'rows', 'tex', 'faces_sorted', 'starts', 'run_counts', 'glist', 'gcount',
        'ranges', 'face_index', 'depth', 'weight', 'face_inv', 'zcorn', 'rgb')] + \
        [(n, ctypes.c_int) for n in (
            'B', 'F', 'L', 'image_size', 'tiles_x', 'tiles_y', 'chunk', 'ts', 'first_col',
            'first_row', 'n_cols', 'n_rows')] + \
        [(n, ctypes.c_float) for n in ('near', 'far', 'eps')]


class _TexBwdArgs(ctypes.Structure):
    """Mirror of ``n3mr::TexBwdArgs`` in csrc/n3mr_texbwd.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        'rows', 'face_index', 'weight', 'depth', 'zcorn', 'grad_rgb', 'grad_tex')] + \
        [(n, ctypes.c_int) for n in ('B', 'F', 'image_size', 'ts')] + \
        [('eps', ctypes.c_float)]


class _EdgeBandArgs(ctypes.Structure):
    """Mirror of ``n3mr::EdgeBandArgs`` in csrc/n3mr_edgebwd.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in ('pp', 'keys', 'items')] + \
        [(n, ctypes.c_int) for n in ('B', 'F', 'image_size', 'key_bytes')]


class _EdgeBwdArgs(ctypes.Structure):
    """Mirror of ``n3mr::EdgeBwdArgs`` in csrc/n3mr_edgebwd.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        'pp', 'fi2', 'planes', 'keys', 'order', 'items', 'slots', 'grad_face')] + \
        [(n, ctypes.c_int) for n in (
            'B', 'F', 'image_size', 'nch', 'return_rgb', 'return_alpha', 'seg_w',
            'n_seg', 'key_bytes')] + \
        [('eps', ctypes.c_float)]


class EdgeBands(NamedTuple):
    """The edge items listed by band.  Item ((axis * B + b) * F + f) * 3 + e
    is edge e of face f of batch element b, walked along axis ``axis``."""
    keys: torch.Tensor    # [N * EDGE_SPAN] sort keys, sorted (see band_keys_plain):
    #                       int32 where they fit (key_dtype), else int64
    order: torch.Tensor   # [N * EDGE_SPAN] int64: each key's item * EDGE_SPAN + j, its
    #                       j-th band from the item's first
    items: torch.Tensor   # [N, 3] int32: first and last d0 row, bands listed (-1:
    #                       the global list, 0: none)


def _device_of(t: torch.Tensor) -> torch.device:
    softras_cuda._need_cuda(t.device)
    return t.device


def maps_args(rows: torch.Tensor, lists: binning.CompactLists, textures,
              is_: int, near: float, far: float, eps: float, tile: int | None = None):
    """The z-buffer kernel's checked arguments and its outputs, allocated
    on the inputs' card: what ``launch_maps`` hands to the kernel (see
    there).  With ``tile`` (a tile of the image, row-major) only the cluster
    that holds it is launched, on the same lists: the maps of its tiles are
    written, the others' are not."""
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
    if tile is None:
        cover = (0, 0, tiles, tiles)
    elif 0 <= tile < NT:
        cover = (tile % tiles, tile // tiles, 1, 1)
    else:
        raise ValueError(f'tile {tile} outside the {NT} of the image')

    def out(*shape, dtype=torch.float32):
        return torch.empty((B, is_, is_) + shape, dtype=dtype, device=dev)

    fi, depth = out(dtype=torch.int32), out()
    weight, face_inv, zcorn = out(3), out(9), out(3)
    rgb = out(3) if textures is not None else None

    args = _MapsArgs(
        rows.data_ptr(), None if textures is None else textures.data_ptr(),
        lists.faces_sorted.data_ptr(), lists.starts.data_ptr(),
        lists.run_counts.data_ptr(), lists.glist.data_ptr(), lists.gcount.data_ptr(),
        lists.ranges.data_ptr(), fi.data_ptr(), depth.data_ptr(), weight.data_ptr(),
        face_inv.data_ptr(), zcorn.data_ptr(), None if rgb is None else rgb.data_ptr(),
        B, F, L, is_, tiles, tiles, MAPS_CHUNK, ts, *cover, near, far, eps)
    return args, (fi, weight, depth, face_inv, zcorn, rgb)


def launch_maps(rows: torch.Tensor, lists: binning.CompactLists, textures,
                is_: int, near: float, far: float, eps: float):
    """Launch the z-buffer kernel on the current stream: a block a tile, a
    cluster of MAPS_SPLIT blocks pooling the lists of as many tiles of a
    column and walking equal shares of them.

    rows [B,F,19] (``torch_impl.face_rows``), ``lists`` the tile lists of
    the y-negated faces, ``textures`` [B,F,ts,ts,ts,3] or None.  Returns
    (face_index [B,H,W] int32, weight [B,H,W,3], depth [B,H,W], face_inv
    [B,H,W,9], zcorn [B,H,W,3], rgb [B,H,W,3] or None): what
    ``torch_impl.forward_maps`` and ``trilinear_rgb_from_maps`` return.
    Any texture size is served.  ``launch_maps.launches`` counts the
    launches."""
    args, out = maps_args(rows, lists, textures, is_, near, far, eps)
    _run(_entry('n3mr_maps', 'n3mr_maps', _MapsArgs, MAPS_SPLIT), 'n3mr_maps', args, rows.device)
    launch_maps.launches += 1
    return out


launch_maps.launches = 0

def maps_defines(build: str):
    """The macro of a z-buffer build named by one digit: the tiles of a
    column that a cluster of as many blocks pools (1, 2, 4 or 8)."""
    if build not in MAPS_BUILDS:
        raise ValueError(f'a z-buffer build is the tiles a cluster pools, one of '
                         f'{MAPS_BUILDS}, got {build!r}')
    return (('N3MR_MAPS_SPLIT', int(build)),)


def maps_variant(defines=()):
    """The z-buffer kernel's entry point built with other compile-time
    choices (``maps_defines``), to time the alternatives to the default
    build; call it with ``maps_args`` through ``_run``.  The wrapper
    launches the default build only."""
    split = dict(defines).get('N3MR_MAPS_SPLIT', MAPS_SPLIT)
    return _entry('n3mr_maps', 'n3mr_maps', _MapsArgs, split,
                  _build.load('n3mr_maps', tuple(defines)))


def maps_occupancy(defines=()) -> dict:
    """Registers, local (spill) bytes and blocks an SM of the z-buffer
    kernel in the build with ``defines``, from the CUDA runtime."""
    fn = _build.load('n3mr_maps', tuple(defines)).n3mr_maps_occupancy
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    err = fn(out)
    if err != 0:
        raise RuntimeError(f'n3mr_maps occupancy query failed: CUDA error {err}')
    return {'registers': out[0], 'local_bytes': out[1], 'blocks_per_sm': out[2]}


def warp_box_plain(is_: int, dtype=torch.float32, device=None):
    """The pixel centres of every warp's first and last column and row, as
    the z-buffer kernel computes them: a warp is 8 x 4 pixels of a 16 x 16
    tile (past a ragged edge too).  Returns (x_lo, x_hi [wx], y_lo, y_hi
    [wy]) over wx = 2 * tiles warp columns and wy = 4 * tiles warp rows."""
    tiles = -(-is_ // TILE)
    c = torch.arange(2 * tiles, device=device) * 8
    r = torch.arange(4 * tiles, device=device) * 4
    def ctr(v):      # torch_impl._pixel_coords' centres
        return (2.0 * v.to(dtype) + 1 - is_) / is_

    return ctr(c), ctr(c + 7), ctr(r), ctr(r + 3)


def warp_skip_plain(rows: torch.Tensor, is_: int) -> torch.Tensor:
    """The plain version of the kernel's warp corner test: [B, F, wy, wx]
    true where an edge of face f rejects every pixel of warp (wy, wx)
    (``warp_box_plain``): its inside-test sides L(yp) = (yp - ya) * (xb -
    xa) and R(xp) = (xp - xa) * (yb - ya), each operation rounded to
    nearest, are monotone in one coordinate where the edge vector is
    finite, so the largest L over the warp's rows and the least R over its
    columns lie at its corners, and L < R there means L < R at every pixel.
    A face whose edge vector is not finite is never skipped by that edge."""
    x_lo, x_hi, y_lo, y_hi = warp_box_plain(is_, rows.dtype, rows.device)
    y_lo, y_hi = y_lo[:, None], y_hi[:, None]                    # [wy, 1]
    out = torch.zeros(rows.shape[:2] + (y_lo.shape[0], x_lo.shape[0]), dtype=torch.bool,
                      device=rows.device)
    for a, b in ((0, 3), (3, 6), (6, 0)):
        xa, ya = rows[..., a, None, None], rows[..., a + 1, None, None]
        A = rows[..., b, None, None] - xa
        Bv = rows[..., b + 1, None, None] - ya
        lmax = torch.maximum((y_lo - ya) * A, (y_hi - ya) * A)
        rmin = torch.minimum((x_lo - xa) * Bv, (x_hi - xa) * Bv)
        out |= A.isfinite() & Bv.isfinite() & (lmax < rmin)
    return out


def maps_split_plain(face: torch.Tensor, is_: int, near: float, far: float, split: int,
                     skip: bool = False, lists: binning.CompactLists | None = None):
    """The plain version of the z-buffer kernel's pooled split: the lists of
    ``split`` tiles of a column (rows ty0 .. ty0 + split - 1, each
    ``binning.tile_list``: its big faces in range, then its run; of
    ``lists`` or ``tile_lists``), one after the other, cut into ``split``
    shares of ceil(total / split) positions; in each share a pixel of every
    tile the share touches keeps the least (depth, id) of that tile's front
    faces that pass its test with near < depth < far (the thread's rule, the
    same in any order), a face rejected for the pixel's warp by
    ``warp_skip_plain`` not tested where ``skip``; each tile's states merged
    in share order by the same rule; the winners' maps formed as
    ``torch_impl.forward_maps`` forms them.  Returns what that returns."""
    B, F = face.shape[:2]
    dev, dt = face.device, face.dtype
    rows = torch_impl.face_rows(face, is_)
    cl = tile_lists(face, is_) if lists is None else lists
    tiles = -(-is_ // TILE)
    wskip = warp_skip_plain(rows, is_) if skip else None
    pix = torch.arange(TILE * TILE, device=dev)
    ly, lx = pix // TILE, pix % TILE
    none = torch.zeros(0, dtype=torch.int64, device=dev)
    best_f = torch.full((B, is_ * is_), -1, dtype=torch.int64, device=dev)
    best_z = torch.full((B, is_ * is_), float('inf'), dtype=dt, device=dev)
    for b in range(B):
        for tx in range(tiles):
            for ty0 in range(0, tiles, split):
                rows_k = [ty0 + k for k in range(split)]
                ids = [binning.tile_list(cl, b, t * tiles + tx, tiles).long() if t < tiles
                       else none for t in rows_k]
                off = [0]
                for i in ids:
                    off.append(off[-1] + i.numel())
                per = max(1, -(-off[-1] // split))
                for k, t in enumerate(rows_k):
                    if t >= tiles or ids[k].numel() == 0:
                        continue
                    rr, cc = t * TILE + ly, tx * TILE + lx
                    live = (rr < is_) & (cc < is_)
                    flat = (rr * is_ + cc)[live]
                    XI, YI, xp, yp = (c[:, None] for c in torch_impl._pixel_coords(flat, is_, dt))
                    bz = torch.full((flat.numel(),), float('inf'), dtype=dt, device=dev)
                    bf = torch.full((flat.numel(),), -1, dtype=torch.int64, device=dev)
                    for r in range(split):       # the shares that touch tile k, in order
                        a0 = max(min(off[-1], r * per), off[k])
                        a1 = min(min(off[-1], r * per + per), off[k + 1])
                        if a0 >= a1:
                            continue
                        share = ids[k][a0 - off[k]:a1 - off[k]]
                        inside, _, zp = torch_impl._pair_terms(rows[b, share][None], XI, YI,
                                                               xp, yp)
                        ok = inside & (zp > near) & (zp < far)
                        if skip:
                            wy, wx = (rr[live] // 4)[:, None], (cc[live] // 8)[:, None]
                            ok &= ~wskip[b, share[None], wy, wx]
                        zkey = torch.where(ok, zp, float('inf'))
                        zr = zkey.amin(dim=1)
                        fr = torch.where(ok & (zkey == zr[:, None]), share[None], F).amin(dim=1)
                        fr = torch.where(fr < F, fr, -1)
                        upd = (fr >= 0) & ((bf < 0) | (zr < bz) | ((zr == bz) & (fr < bf)))
                        bz = torch.where(upd, zr, bz)
                        bf = torch.where(upd, fr, bf)
                    best_z[b, flat] = bz
                    best_f[b, flat] = bf
    coords = torch_impl._pixel_coords(torch.arange(is_ * is_, device=dev), is_, dt)
    maps = torch_impl.maps_of_winners(rows, best_f, best_z, coords, far)
    return tuple(m.reshape(B, is_, is_, *m.shape[2:]) for m in maps)


def texbwd_args(rows, tex_shape, face_index, weight, depth, zcorn, grad_rgb, eps: float):
    """The texture-gradient kernel's checked arguments and its output
    grad_tex [B,F,ts,ts,ts,3], allocated on the inputs' card: what
    ``launch_texbwd`` hands to the kernel."""
    dev = _device_of(rows)
    B, F, ts = tex_shape[:3]
    if ts < 1:
        raise ValueError(f'the texture size must be at least 1, got {ts}')
    if face_index.dim() != 3:
        raise ValueError(f'face_index must be [B, is, is], got {tuple(face_index.shape)}')
    is_ = face_index.shape[1]
    _check(rows, 'rows', torch.float32, (B, F, ROW), dev)
    _check(face_index, 'face_index', torch.int32, (B, is_, is_), dev)
    _check(weight, 'weight', torch.float32, (B, is_, is_, 3), dev)
    _check(depth, 'depth', torch.float32, (B, is_, is_), dev)
    _check(zcorn, 'zcorn', torch.float32, (B, is_, is_, 3), dev)
    _check(grad_rgb, 'grad_rgb', torch.float32, (B, is_, is_, 3), dev)
    grad_tex = torch.empty((B, F, ts, ts, ts, 3), dtype=torch.float32, device=dev)
    args = _TexBwdArgs(rows.data_ptr(), face_index.data_ptr(), weight.data_ptr(),
                       depth.data_ptr(), zcorn.data_ptr(), grad_rgb.data_ptr(),
                       grad_tex.data_ptr(), B, F, is_, ts, eps)
    return args, grad_tex


def launch_texbwd(rows, tex_shape, face_index, weight, depth, zcorn, grad_rgb,
                  eps: float):
    """Launch the texture-gradient kernel on the current stream: grad_tex
    [B,F,ts,ts,ts,3] from the forward's rows [B,F,19] and maps and the rgb
    gradient [B,H,W,3].  Any texture size is served: up to 4 with the sums
    in registers, up to 6 in one walk of a face's pixels, a larger one in
    several.  Deterministic: no atomics, every sum in a fixed order.
    ``launch_texbwd.launches`` counts the launches."""
    args, grad_tex = texbwd_args(rows, tex_shape, face_index, weight, depth, zcorn, grad_rgb,
                                 eps)
    _run(_entry('n3mr_texbwd', 'n3mr_texbwd', _TexBwdArgs), 'n3mr_texbwd', args, rows.device)
    launch_texbwd.launches += 1
    return grad_tex


launch_texbwd.launches = 0


def texbwd_occupancy(ts: int) -> dict:
    """Registers, local (spill) bytes and blocks an SM of the texture-gradient
    kernel's instance for texture size ``ts`` (register sums up to 4, shared
    ones above), from the CUDA runtime."""
    fn = _build.load('n3mr_texbwd').n3mr_texbwd_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    err = fn(ts, out)
    if err != 0:
        raise RuntimeError(f'n3mr_texbwd occupancy query failed: CUDA error {err}')
    return {'registers': out[0], 'local_bytes': out[1], 'blocks_per_sm': out[2]}


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
    with annotate('jr.n3mr.edge.inputs'):
        B, F = face.shape[:2]
        pp = torch.cat([
            torch_impl._pixel_space(face.reshape(B, F, 3, 3)[..., :2], is_).reshape(B, F, 6),
            torch_impl._face_frontside_n3mr(face).to(face.dtype)[..., None]],
            dim=-1).contiguous()
        ch = []
        if return_alpha:
            ch += [alpha_map[:, None], grad_alpha[:, None]]
        if return_rgb:
            ch += [rgb_map.permute(0, 3, 1, 2), grad_rgb.permute(0, 3, 1, 2)]
        planes = torch.cat(ch, dim=1)
        return (pp, torch.stack([face_index.transpose(1, 2), face_index]).contiguous(),
                torch.stack([planes.transpose(2, 3), planes]).contiguous())


class KeyLayout(NamedTuple):
    """Where the band keys fall (``band_count``, ``group_keys`` and
    ``gbase`` of csrc/n3mr_edgebwd.cu): group g = (axis * B + b) * n_bands
    + band lists the keys [g * group, (g + 1) * group); the global items'
    keys start at gbase; every key lies below top."""
    n_bands: int
    group: int
    gbase: int
    top: int


def key_layout(B: int, F: int, is_: int, band: int = EDGE_BAND) -> KeyLayout:
    n_bands = -(-is_ // band)
    group = band * 3 * F
    gbase = 2 * B * n_bands * group
    return KeyLayout(n_bands, group, gbase, gbase + 6 * B * F * (1 + EDGE_SPAN))


def key_dtype(B: int, F: int, is_: int, band: int = EDGE_BAND) -> torch.dtype:
    """The band keys' type: int32 where the largest key fits (sorting it
    takes half the passes of int64), else int64."""
    return torch.int32 if key_layout(B, F, is_, band).top < 2 ** 31 else torch.int64


def band_keys_plain(pp: torch.Tensor, is_: int, band: int = EDGE_BAND):
    """The plain version of the band-key kernel: (keys [N * EDGE_SPAN] of
    ``key_dtype``, unsorted, items [N, 3] int32) for pp [B, F, 7]
    (``edge_inputs``).

    An item's d0 rows are ``torch_impl._edge_rows``' (a back face, a NaN
    corner or an empty range: none); it spans bands first // band to
    last // band.  Over at most EDGE_SPAN bands, its j-th band gets the key
    ((axis * B + b) * n_bands + band) * (band * 3F) + row0 * 3F + f * 3 + e
    (row0: the item's first row in the band), so a band's list is sorted by
    first row, face and edge; over more, its first key is gbase + item
    (the global list, gbase = 2 B n_bands band 3F), and every other key is
    gbase + N + item * EDGE_SPAN + j, which no list reads."""
    B, F = pp.shape[:2]
    dev = pp.device
    e = torch.arange(3, device=dev)
    p0 = torch.stack([pp[..., 2 * e + axis] for axis in (0, 1)])               # [2,B,F,3]
    p1 = torch.stack([pp[..., 2 * ((e + 1) % 3) + axis] for axis in (0, 1)])
    d0_from = torch.minimum(p0, p1).ceil().clamp_min(0.0)
    d0_to = torch.maximum(p0, p1).clamp_max(is_ - 1.0)
    ok = (pp[..., 6] > 0.5)[None, :, :, None] & (d0_from <= d0_to)
    first = torch.where(ok, d0_from, 0.0).long()
    last = torch.where(ok, d0_to.floor(), -1.0).long()
    bfrom = first // band
    nb = torch.where(ok, last // band - bfrom + 1, 0)
    glob = nb > EDGE_SPAN
    items = torch.stack([first, last, torch.where(glob, -1, nb)], -1).reshape(-1, 3).int()

    N = 6 * B * F
    n_bands, gk, gbase, _ = key_layout(B, F, is_, band)
    it = torch.arange(N, device=dev).reshape(2, B, F, 3)
    ab = torch.arange(2 * B, device=dev).reshape(2, B, 1, 1)
    fe = (torch.arange(F, device=dev)[:, None] * 3 + e)                        # [F,3]
    j = torch.arange(EDGE_SPAN, device=dev)
    band_j = bfrom[..., None] + j
    row0 = (first[..., None] - band_j * band).clamp_min(0)
    listed = ((ab[..., None] * n_bands + band_j) * gk + row0 * 3 * F + fe[..., None])
    key = gbase + N + it[..., None] * EDGE_SPAN + j
    key = torch.where(~glob[..., None] & (j < nb[..., None]), listed, key)
    key = torch.where(glob[..., None] & (j == 0), gbase + it[..., None], key)
    return key.reshape(-1).to(key_dtype(B, F, is_, band)), items


def _edge_lib(band: int):
    """The edge kernels' library built with bands of ``band`` rows (the
    default build for EDGE_BAND)."""
    lib = _build.load('n3mr_edgebwd', () if band == EDGE_BAND else (('N3MR_EDGE_BAND', band),))
    if _c_int(lib, 'n3mr_edgebwd_band') != band or _c_int(lib, 'n3mr_edgebwd_span') != EDGE_SPAN:
        raise RuntimeError(f'n3mr_edgebwd takes bands of {_c_int(lib, "n3mr_edgebwd_band")} rows '
                           f'and {_c_int(lib, "n3mr_edgebwd_span")} bands an item, the wrapper '
                           f'{band} and {EDGE_SPAN}')
    return lib


def edge_bands_args(pp: torch.Tensor, is_: int, band: int = EDGE_BAND):
    """The band-key kernel's checked arguments and its outputs (keys
    [N * EDGE_SPAN] of ``key_dtype``, items [N, 3] int32: what
    ``band_keys_plain`` returns), allocated on pp's card, for bands of
    ``band`` rows: what ``launch_edge_bands`` hands to the kernel."""
    dev = _device_of(pp)
    if pp.dim() != 3:
        raise ValueError(f'pp must be [B, F, 7], got {tuple(pp.shape)}')
    B, F = pp.shape[:2]
    _check(pp, 'pp', torch.float32, (B, F, 7), dev)
    keys = torch.empty((6 * B * F * EDGE_SPAN,), dtype=key_dtype(B, F, is_, band), device=dev)
    items = torch.empty((6 * B * F, 3), dtype=torch.int32, device=dev)
    args = _EdgeBandArgs(pp.data_ptr(), keys.data_ptr(), items.data_ptr(), B, F, is_,
                         keys.element_size())
    return args, (keys, items)


def _band_keys(pp: torch.Tensor, is_: int, lib):
    band = _c_int(lib, 'n3mr_edgebwd_band')
    args, out = edge_bands_args(pp, is_, band)
    gbase = lib.n3mr_edge_gbase
    gbase.argtypes, gbase.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    got, want = gbase(args.B, args.F, is_), key_layout(args.B, args.F, is_, band).gbase
    if got != want:
        raise RuntimeError(f'n3mr_edge_bands puts the global keys at {got}, key_layout at {want}')
    _run(_entry('n3mr_edgebwd', 'n3mr_edge_bands', _EdgeBandArgs, lib=lib), 'n3mr_edge_bands',
         args, pp.device)
    return out


def launch_edge_bands(pp: torch.Tensor, is_: int):
    """Launch the band-key kernel on the current stream: what
    ``band_keys_plain`` returns.  ``launch_edge_bands.launches`` counts the
    launches."""
    _device_of(pp)
    out = _band_keys(pp, is_, _edge_lib(EDGE_BAND))
    launch_edge_bands.launches += 1
    return out


launch_edge_bands.launches = 0


def edge_bands(pp: torch.Tensor, is_: int, band: int = EDGE_BAND, lib=None) -> EdgeBands:
    """The edge items listed by band, keys sorted (``torch.sort``: the keys
    are distinct, so the order is fixed); the card's keys from the kernel
    (``lib``: a band variant's, uncounted), the CPU's from the plain
    version.  No host synchronisation."""
    if _by_device(pp):
        keys, items = launch_edge_bands(pp, is_) if lib is None else _band_keys(pp, is_, lib)
    else:
        keys, items = band_keys_plain(pp, is_, band)
    with annotate('jr.n3mr.edge.sort'):
        skeys, order = torch.sort(keys)
    return EdgeBands(skeys, order, items)


def edge_segment_width(is_: int, nch: int, band: int = EDGE_BAND) -> int:
    """Columns of a band block: the whole row where ``band`` rows of the
    face index and the ``nch`` channels fit EDGE_SMEM_BYTES, else the most
    that fit, a multiple of 32."""
    per_col = 4 * band * (1 + nch)
    if per_col * is_ <= EDGE_SMEM_BYTES:
        return is_
    return max(32, EDGE_SMEM_BYTES // per_col // 32 * 32)


def _edgebwd(pp, fi2, planes, eps, return_rgb, return_alpha, bands: EdgeBands, lib, band):
    dev = _device_of(pp)
    if not (return_rgb or return_alpha):
        raise ValueError('the edge gradient needs return_rgb or return_alpha')
    if pp.dim() != 3 or fi2.dim() != 4:
        raise ValueError(f'pp must be [B, F, 7] and fi2 [2, B, is, is], got '
                         f'{tuple(pp.shape)} and {tuple(fi2.shape)}')
    B, F = pp.shape[:2]
    is_ = fi2.shape[-1]
    nch = (2 if return_alpha else 0) + (6 if return_rgb else 0)
    N = 6 * B * F
    _check(pp, 'pp', torch.float32, (B, F, 7), dev)
    _check(fi2, 'fi2', torch.int32, (2, B, is_, is_), dev)
    _check(planes, 'planes', torch.float32, (2, B, nch, is_, is_), dev)
    _check(bands.keys, 'keys', key_dtype(B, F, is_, band), (N * EDGE_SPAN,), dev)
    _check(bands.order, 'order', torch.int64, (N * EDGE_SPAN,), dev)
    _check(bands.items, 'items', torch.int32, (N, 3), dev)
    seg_w = edge_segment_width(is_, nch, band)
    n_seg = -(-is_ // seg_w)
    slots = torch.empty((N * EDGE_SPAN, n_seg, 2), dtype=torch.float32, device=dev)
    grad_face = torch.empty((B, F, 9), dtype=torch.float32, device=dev)
    fn = _entry('n3mr_edgebwd', 'n3mr_edgebwd', _EdgeBwdArgs, lib=lib)
    args = _EdgeBwdArgs(pp.data_ptr(), fi2.data_ptr(), planes.data_ptr(), bands.keys.data_ptr(),
                        bands.order.data_ptr(), bands.items.data_ptr(), slots.data_ptr(),
                        grad_face.data_ptr(), B, F, is_, nch, int(return_rgb),
                        int(return_alpha), seg_w, n_seg, bands.keys.element_size(), eps)
    _run(fn, 'n3mr_edgebwd', args, dev)
    return grad_face


def launch_edgebwd(pp, fi2, planes, eps: float, return_rgb: bool, return_alpha: bool):
    """Launch the edge-gradient kernels on the current stream: grad_face
    [B,F,9] (x and y columns; z is 0) from ``edge_inputs``, on the bands
    that ``edge_bands`` lists (its band-key kernel counts in
    ``launch_edge_bands``).  Deterministic: no float atomics, every sum in a
    fixed order.  ``launch_edgebwd.launches`` counts the launches."""
    _device_of(pp)
    bands = edge_bands(pp, fi2.shape[-1])
    grad_face = _edgebwd(pp, fi2, planes, eps, return_rgb, return_alpha, bands,
                         _edge_lib(EDGE_BAND), EDGE_BAND)
    launch_edgebwd.launches += 1
    return grad_face


launch_edgebwd.launches = 0


def edgebwd_variant(band: int):
    """``launch_edgebwd`` built with bands of ``band`` rows (the kernel's
    N3MR_EDGE_BAND), uncounted: for a tool that times the alternatives to
    EDGE_BAND.  The wrappers launch the default build only."""
    lib = _edge_lib(band)

    def run(pp, fi2, planes, eps, return_rgb, return_alpha):
        bands = edge_bands(pp, fi2.shape[-1], band, lib)
        return _edgebwd(pp, fi2, planes, eps, return_rgb, return_alpha, bands, lib, band)

    return run


def edgebwd_bands_plain(face, face_index, rgb_map, alpha_map, grad_rgb, grad_alpha, is_: int,
                        eps: float, return_rgb: bool, return_alpha: bool,
                        band: int = EDGE_BAND):
    """The plain version of the edge kernels' decomposition: the items
    listed by ``band_keys_plain``; each listed (item, band) the sum of the
    item's cell terms on the band's rows (``torch_impl._edge_cells``), each
    global item the sum over all its rows; each item's partials added in
    ascending band order; the nine entries formed as the kernel forms them.
    Returns grad_face [B, F, 9]."""
    B, F = face.shape[:2]
    dev, dt = face.device, face.dtype
    pp = edge_inputs(face, face_index, rgb_map, alpha_map, grad_rgb, grad_alpha, is_,
                     return_rgb, return_alpha)[0]
    keys, items = band_keys_plain(pp, is_, band)
    keys, order = torch.sort(keys)
    N = 6 * B * F
    n_bands, gk, gbase, _ = key_layout(B, F, is_, band)
    # the cell terms of every item, summed per band: [2, B, F, 3, n_bands, 2]
    per_band = torch.zeros((2, B, F, 3, n_bands, 2), dtype=dt, device=dev)
    pad = n_bands * band - is_
    for b in range(B):
        pp_b = pp[b, :, :6].reshape(F, 3, 2)
        front = pp[b, :, 6] > 0.5
        fids = torch.arange(F, device=dev)
        for e in range(3):
            for axis in range(2):
                r = torch_impl._edge_rows(pp_b, front, fids, face_index[b].reshape(-1).long(),
                                          is_, e, axis)
                cells = torch_impl._edge_cells(r, fids, axis, face_index[b].long(), alpha_map[b],
                                               grad_alpha[b], rgb_map[b], grad_rgb[b], is_, eps,
                                               return_rgb, return_alpha)
                for k in range(2):       # the endpoints pi[0] (c1) and pi[1] (c2)
                    rows = sum(c[k].sum(dim=2) for c in cells)                  # [F, is]
                    rows = torch.nn.functional.pad(rows, (0, pad))
                    per_band[axis, b, :, e, :, k] = rows.reshape(F, n_bands, band).sum(-1)
    per_band = per_band.reshape(N, n_bands, 2)
    slots = torch.zeros((N * EDGE_SPAN, 2), dtype=dt, device=dev)
    it, j = order // EDGE_SPAN, order % EDGE_SPAN
    listed = keys < gbase
    group = keys[listed] // gk
    slots[order[listed]] = per_band[it[listed], group % n_bands]
    glob = (keys >= gbase) & (keys < gbase + N)
    slots[order[glob]] = per_band[it[glob]].sum(dim=1)
    slots = slots.reshape(N, EDGE_SPAN, 2)
    nb = items[:, 2].long()
    c = torch.where((nb < 0)[:, None], slots[:, 0], 0.0)
    for jj in range(EDGE_SPAN):            # ascending band order
        c = c + torch.where((jj < nb)[:, None], slots[:, jj], 0.0)
    c = c.reshape(2, B, F, 3, 2)          # [axis, b, f, e, (c1, c2)]
    out = torch.zeros((B, F, 3, 3), dtype=dt, device=dev)
    for v in range(3):
        for col in range(2):
            ax = 1 - col
            out[:, :, v, col] = -c[ax, :, :, v, 0] - c[ax, :, :, (v + 2) % 3, 1]
    return out.reshape(B, F, 9)


def tile_lists(face: torch.Tensor, is_: int) -> binning.CompactLists:
    """The z-buffer kernel's tile lists.  The binning's rows fall with y,
    n3mr's grow with it (``torch_impl._pixel_coords``), so a y-negated copy
    of the faces is binned: the row extents then line up."""
    neg_y = face * device_constant([1.0, -1.0, 1.0] * 3, face.device, face.dtype)
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
    card = _by_device(face)
    with annotate('jr.raster.prep'):
        rows = torch_impl.face_rows(face, is_)
        lists = tile_lists(face, is_) if card else None
    if card:
        return (rows,) + launch_maps(rows, lists, textures, is_, near, far, eps)
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
