"""SoftRas over screen tiles whose face lists are written out tile after
tile: what the pxg (``pxg_impl``), f_px (``fpx_impl``) and px_f
(``pxf_impl``) routes share.

All three read the binning of ``binning.build_tile_lists_compact`` at
their tile shape, written out tile after tile and cut into work items by
``tile_work`` (big faces included, no caps), and end their backward with
the face sum ``face_sum``: each face's entry rows added in ascending tile
order by the segment sum (``ops/segment_sum.py``, csrc/segment_sum.cu),
whose plain version is ``sum_plain``.

The two JAX layouts f_px and px_f (``jrender_tpu/ops/softras/
pallas_impl.py``) compute the binned route's function on other tiles: f_px
on 16 x min(128, is) tiles in 32-face chunks, px_f on t x t tiles (t = 32,
16 or 8) in 128-face chunks, with a top-K threshold and a band of tile
rows.  Here both have the same two kernels:

  forward   csrc/softras_tile_fwd.cuh  a block per tile of the band walks
            the tile's whole list: image, aggregates, counts and, when
            asked, the top-K threshold
  backward  csrc/softras_tile_bwd.cuh  a block per work item (a tile and
            a run of at most ``group`` faces of its list): one gradient
            row per entry, summed over the tile's pixels

Each route has its own sources (``csrc/softras_{fpx,pxf}_{fwd,bwd}.cu``),
counted wrappers and rules (tile shape, work-item size, threshold); the
functions here are the prep, the plain versions, the launches without
counts, and ``forward`` / ``backward``, which go by the device of their
input and take the route's wrapper for the card.

Bands.  ``band`` = (ty0, ty_band) keeps the tile rows [ty0, ty0 +
ty_band): only their tiles have lists and items, the outputs and maps are
[B, C, ty_band * tile_h, is], and pixel centres use the global row
(``pallas_impl.py:1454-1457``).
"""
from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple

import torch

from .. import segment_sum
from . import cuda_impl, torch_impl
from .cuda_impl import ROW_BASE, _Scalars, _check, _entry, _run, _scalars
from .params import SoftRasParams

BWD_WARPS = 8         # warps of a backward block (kBwdWarps)


def _offsets(n: torch.Tensor) -> torch.Tensor:
    """[len + 1] exclusive prefix sums of n (int64)."""
    return torch.cat([n.new_zeros(1), n.cumsum(0)])


class TileWork(NamedTuple):
    """Every tile's face list written out tile after tile, and its work
    items.  A global tile is b * NT + t."""
    entries: torch.Tensor               # [E] i32 face ids: each tile's big faces, then its run
    tile_off: torch.Tensor              # [B*NT + 1] i32 first entry of each tile
    items: torch.Tensor                 # [W, 3] i32 (global tile, first entry, end)
    item_off: torch.Tensor              # [B*NT + 1] i32 first item of each tile
    face_off: torch.Tensor | None       # [B*F + 1] i32 first place of each face in
    face_entries: torch.Tensor | None   # [E] i32: its entries, ascending (for_grad)


def tile_work(cl, B: int, F: int, tiles_y: int, tiles_x: int, group: int,
              for_grad: bool = False, band: tuple[int, int] | None = None) -> TileWork:
    """The lists of ``binning.build_tile_lists_compact`` (any tile shape,
    ``tiles_y`` x ``tiles_x`` tiles) written out tile after tile, big faces
    included, and cut into work items of at most ``group`` faces; plain
    torch on the device of the lists, with one host synchronisation that
    reads the sizes.  ``band`` = (first tile row, number of rows) keeps the
    tiles of those rows only: the others get empty lists and no items.
    ``for_grad`` adds each face's entries, which a face sum walks."""
    if group < 1:
        raise ValueError(f'a work item holds at least one face, got group={group}')
    dev = cl.counts.device
    NT = tiles_y * tiles_x
    r0, r1 = (0, tiles_y) if band is None else (band[0], band[0] + band[1])
    counts = cl.counts.reshape(-1).long()           # faces per tile, big faces included
    runs = cl.run_counts.reshape(-1).long()
    if band is not None:
        row = (torch.arange(B * NT, device=dev) % NT) // tiles_x
        in_band = (row >= r0) & (row < r1)
        counts = torch.where(in_band, counts, 0)
        runs = torch.where(in_band, runs, 0)
    nbig = counts - runs
    n_items = (counts + group - 1) // group
    E, W, NB, NG = (int(v) for v in torch.stack(
        [counts.sum(), n_items.sum(), nbig.sum(), cl.gcount.long().sum()]).tolist())
    tile_off = _offsets(counts)
    tid = torch.arange(B * NT, device=dev)
    entries = torch.empty(E, dtype=torch.int32, device=dev)

    # each tile's sorted run, after its big faces
    run_tile = torch.repeat_interleave(tid, runs, output_size=E - NB)
    k = torch.arange(E - NB, device=dev) - _offsets(runs)[run_tile]
    src = cl.starts.reshape(-1).long()[run_tile] + k
    entries[tile_off[run_tile] + nbig[run_tile] + k] = cl.faces_sorted[run_tile // NT, src]

    # the big faces: each enumerates the tiles of its range (within the
    # band); a stable sort by tile keeps a tile's big faces in ascending order
    if NB:
        flat = cl.glist.reshape(-1)
        place = torch.argsort((flat < 0).to(torch.int8), stable=True)[:NG]
        g_b = place // F
        g_face = flat[place].long()
        rg = cl.ranges[g_b, g_face].long()                       # ty0, ty1, tx0, tx1
        ty_lo, ty_hi = rg[:, 0].clamp_min(r0), rg[:, 1].clamp_max(r1 - 1)
        w = rg[:, 3] - rg[:, 2] + 1
        area = (ty_hi - ty_lo + 1).clamp_min(0) * w
        owner = torch.repeat_interleave(torch.arange(NG, device=dev), area, output_size=NB)
        k = torch.arange(NB, device=dev) - _offsets(area)[owner]
        ww = w[owner]
        tile = g_b[owner] * NT + (ty_lo[owner] + k // ww) * tiles_x + rg[owner, 2] + k % ww
        tile_s, order = torch.sort(tile, stable=True)
        rank = torch.arange(NB, device=dev) - _offsets(nbig)[tile_s]
        entries[tile_off[tile_s] + rank] = g_face[owner[order]].to(torch.int32)

    item_off = _offsets(n_items)
    item_tile = torch.repeat_interleave(tid, n_items, output_size=W)
    first = tile_off[item_tile] + (torch.arange(W, device=dev) - item_off[item_tile]) * group
    end = torch.minimum(first + group, tile_off[item_tile + 1])
    items = torch.stack([item_tile, first, end], dim=1).to(torch.int32).contiguous()

    face_off = face_entries = None
    if for_grad:
        owner = torch.repeat_interleave(tid // NT, counts, output_size=E)
        key = owner * F + entries.long()
        face_entries = torch.sort(key, stable=True).indices.to(torch.int32)
        face_off = _offsets(torch.bincount(key, minlength=B * F)).to(torch.int32)
    return TileWork(entries, tile_off.to(torch.int32), items, item_off.to(torch.int32),
                    face_off, face_entries)


class TiledInputs(NamedTuple):
    """What the tiled kernels read.  A global tile is b * NT + t."""
    rows: torch.Tensor                  # [B, F, 31 + 3T] f32 (cuda_impl.face_rows)
    entries: torch.Tensor               # [E] i32 face ids of the band's tiles' lists
    tile_off: torch.Tensor              # [B*NT + 1] i32 first entry of each tile
    items: torch.Tensor                 # [W, 3] i32 (global tile, first entry, end)
    item_off: torch.Tensor              # [B*NT + 1] i32 first item of each tile
    face_off: torch.Tensor | None       # [B*F + 1] i32 first place of each face in
    face_entries: torch.Tensor | None   # [E] i32: its entries, ascending (for_grad)
    tex_res: int                        # R, T = R * R (1 for vertex colours)
    tile_h: int
    tile_w: int
    tiles_y: int
    tiles_x: int
    ty0: int                            # the band: its first tile row ...
    ty_band: int                        # ... and its number of tile rows


def prep(face_vertices: torch.Tensor, textures: torch.Tensor, p: SoftRasParams,
         tile_h: int, tile_w: int, group: int, for_grad: bool = False,
         band: tuple[int, int] | None = None) -> TiledInputs:
    """Rows, tile lists and work items of ``tile_h`` x ``tile_w`` tiles,
    plain torch on the device of the input (one host synchronisation)."""
    B, F = face_vertices.shape[:2]
    is_ = p.image_size
    tiles_y, tiles_x = -(-is_ // tile_h), -(-is_ // tile_w)
    ty0, ty_band = (0, tiles_y) if band is None else band
    if not (0 <= ty0 and ty_band >= 1 and ty0 + ty_band <= tiles_y):
        raise ValueError(f'the band of tile rows [{ty0}, {ty0 + ty_band}) does not lie in '
                         f'the {tiles_y} rows of the image')
    base = cuda_impl.prepare(face_vertices, textures, p, tile_h=tile_h, tile_w=tile_w)
    work = tile_work(base.lists, B, F, tiles_y, tiles_x, group, for_grad,
                              None if band is None else (ty0, ty_band))
    return TiledInputs(base.rows, *work, base.tex_res, tile_h, tile_w, tiles_y, tiles_x,
                       ty0, ty_band)


def band_height(pin: TiledInputs) -> int:
    """Rows of the band's maps."""
    return pin.ty_band * pin.tile_h


def _tile_pixels(pin: TiledInputs, ty: int, tx: int, is_: int, dev):
    """Global (row, col) of a tile's pixels inside the image, row-major."""
    r = torch.arange(ty * pin.tile_h, min((ty + 1) * pin.tile_h, is_), device=dev)
    c = torch.arange(tx * pin.tile_w, min((tx + 1) * pin.tile_w, is_), device=dev)
    return r[:, None].expand(-1, c.numel()).reshape(-1), c.repeat(r.numel())


def _tex(pin: TiledInputs, p: SoftRasParams, r: torch.Tensor):
    """The texture values of rows r [n, row]: [n, T, 3] or [n, 3, 3]."""
    n = r.shape[0]
    if p.texture_type_id == 0:
        return r[:, ROW_BASE:].reshape(n, pin.tex_res ** 2, 3)
    return r[:, ROW_BASE:].reshape(n, 3, 3)


# --------------------------------------------------------------------------
# the plain versions
# --------------------------------------------------------------------------

def fwd_plain(pin: TiledInputs, p: SoftRasParams, with_thr: bool,
              chunk_pairs: int = torch_impl.CHUNK_PAIRS):
    """The plain version of the forward kernel: per tile of the band, the
    plain forward (``torch_impl.forward_single``) over the tile's list,
    ties to the lowest id; with ``with_thr`` the K-th smallest candidate
    depth of the list, ``far`` where a pixel has at most K.  A tile
    without faces gets the background and the initial aggregates.
    Returns (images [B,4,Hb,is], aggrs [B,2,Hb,is], counts [B,Hb,is] i32,
    thr [B,Hb,is] or None), Hb = ``band_height(pin)``."""
    B, F = pin.rows.shape[:2]
    dev, dt = pin.rows.device, pin.rows.dtype
    is_, K = p.image_size, p.max_faces_id
    Hb = band_height(pin)
    images = torch.empty((B, 4, Hb, is_), dtype=dt, device=dev)
    aggrs = torch.empty((B, 2, Hb, is_), dtype=dt, device=dev)
    counts = torch.zeros((B, Hb, is_), dtype=torch.int32, device=dev)
    thr = torch.full((B, Hb, is_), p.far, dtype=dt, device=dev) if with_thr else None
    bg = torch.tensor(p.background_color, dtype=dt, device=dev)
    if p.rgb_func_id == 1:
        ag_init = torch.tensor([1.0, p.eps], dtype=dt, device=dev)
    elif p.rgb_func_id == 0:
        ag_init = torch.tensor([torch_impl.BIG_DEPTH, -1.0], dtype=dt, device=dev)
    else:
        ag_init = torch.zeros(2, dtype=dt, device=dev)
    off = pin.tile_off.tolist()
    for b in range(B):
        for by in range(pin.ty_band):
            ty = pin.ty0 + by
            for tx in range(pin.tiles_x):
                tile_g = (b * pin.tiles_y + ty) * pin.tiles_x + tx
                rr, cc = _tile_pixels(pin, ty, tx, is_, dev)
                lr = rr - pin.ty0 * pin.tile_h
                ids = pin.entries[off[tile_g]:off[tile_g + 1]].long()
                if ids.numel() == 0:
                    images[b, :3, lr, cc] = bg[:, None]
                    images[b, 3, lr, cc] = 0.0
                    aggrs[b, :, lr, cc] = ag_init[:, None]
                    continue
                r = pin.rows[b, ids]
                xp, yp = torch_impl.pixel_centers(rr, cc, is_)
                step = max(1, chunk_pairs // ids.numel())
                for s in range(0, rr.numel(), step):
                    sl = slice(s, s + step)
                    col, ag, cnt = torch_impl.forward_single(
                        r[:, :9], _tex(pin, p, r), p, xp[sl], yp[sl], ids=ids, n_faces=F)
                    images[b, :, lr[sl], cc[sl]] = col.T
                    aggrs[b, :, lr[sl], cc[sl]] = ag.T
                    counts[b, lr[sl], cc[sl]] = cnt
                    if with_thr and ids.numel() > K:
                        key = torch_impl._candidate_depths(r[:, :9], p, xp[sl], yp[sl])
                        kth = torch.kthvalue(key, K, dim=1).values
                        thr[b, lr[sl], cc[sl]] = torch.where(cnt > K, kth, p.far)
    return images, aggrs, counts, thr


def bwd_rows_plain(pin: TiledInputs, images, aggrs, thr, grad_images, p: SoftRasParams):
    """The plain version of the backward kernel: for every entry (tile,
    face) of every work item, the face's gradient summed over the tile's
    pixels (``torch_impl.backward_single`` on the item; the maps are the
    band's).  Returns rows [E, 9 + 3T or 18]."""
    B, F = pin.rows.shape[:2]
    dev = pin.rows.device
    is_ = p.image_size
    NT = pin.tiles_y * pin.tiles_x
    GC = cuda_impl._grad_columns(p, pin.tex_res)
    rows_out = torch.zeros((pin.entries.numel(), GC), dtype=pin.rows.dtype, device=dev)
    for tile_g, first, end in pin.items.tolist():
        b, t = divmod(tile_g, NT)
        ty, tx = divmod(t, pin.tiles_x)
        rr, cc = _tile_pixels(pin, ty, tx, is_, dev)
        lr = rr - pin.ty0 * pin.tile_h
        ids = pin.entries[first:end]
        r = pin.rows[b, ids.long()]
        xp, yp = torch_impl.pixel_centers(rr, cc, is_)

        def at(x):
            return x[b][:, lr, cc].T

        gf, gt = torch_impl.backward_single(
            r[:, :9], _tex(pin, p, r), at(images), at(aggrs), at(grad_images), p, xp, yp,
            None if thr is None else thr[b, lr, cc], ids=ids, n_faces=F)
        rows_out[first:end] = torch.cat([gf, gt.reshape(end - first, -1)], dim=1)
    return rows_out


# --------------------------------------------------------------------------
# the kernels' launches (the routes' wrappers count them)
# --------------------------------------------------------------------------

class _TileFwdArgs(ctypes.Structure):
    """Mirror of ``softras::TileFwdArgs`` in csrc/softras_tile_fwd.cuh."""
    _fields_ = [(n, ctypes.c_void_p) for n in ('rows', 'entries', 'tile_off', 'image',
                                               'aggrs', 'counts', 'thr')] + \
        [(n, ctypes.c_int) for n in ('B', 'F', 'row', 'image_size', 'tile_h', 'tile_w',
                                     'tiles_x', 'tiles_y', 'ty0', 'ty_band', 'chunk', 'K')] + \
        [('bis_lo', ctypes.c_uint), ('bis_hi', ctypes.c_uint), ('bis_iters', ctypes.c_int)] + \
        [(n, ctypes.c_int) for n in ('dist_func', 'rgb_func', 'alpha_func')] + \
        [('s', _Scalars)]


class _TileBwdArgs(ctypes.Structure):
    """Mirror of ``softras::TileBwdArgs`` in csrc/softras_tile_bwd.cuh."""
    _fields_ = [(n, ctypes.c_void_p) for n in ('rows', 'entries', 'items', 'image', 'aggrs',
                                               'grad', 'thr', 'grows')] + \
        [(n, ctypes.c_int) for n in ('W', 'F', 'row', 'image_size', 'tile_h', 'tile_w',
                                     'tiles_x', 'tiles_y', 'ty0', 'band_h', 'chunk', 'GC',
                                     'dist_func', 'rgb_func', 'alpha_func')] + \
        [('s', _Scalars)]


def depth_key(z: float) -> int:
    """The order-preserving unsigned key of a float32 (``softras_topk.cuh``
    ``depth_key``)."""
    u = struct.unpack('<I', struct.pack('<f', z))[0]
    return (~u & 0xffffffff) if u & 0x80000000 else u | 0x80000000


def check_inputs(pin: TiledInputs, p: SoftRasParams):
    """Rows, lists and items on one card, of the types, shapes and layout
    the kernels index.  Returns (device, B, F, row)."""
    rows = pin.rows
    dev = rows.device
    if dev.type != 'cuda':
        raise ValueError(f'the CUDA kernel needs CUDA tensors, got {dev}')
    if rows.dim() != 3:
        raise ValueError(f'rows must be [B, F, row], got {tuple(rows.shape)}')
    B, F, row = rows.shape
    expect = 3 * pin.tex_res ** 2 if p.texture_type_id == 0 else 9
    if row - ROW_BASE != expect:
        raise ValueError(f'rows hold {row - ROW_BASE} texture values, expected {expect}')
    if B > 65535:
        raise ValueError(f'the kernels take at most 65,535 batch elements, got {B}')
    is_ = p.image_size
    if (pin.tiles_y, pin.tiles_x) != (-(-is_ // pin.tile_h), -(-is_ // pin.tile_w)):
        raise ValueError(f'{pin.tiles_y} x {pin.tiles_x} tiles of {pin.tile_h} x '
                         f'{pin.tile_w} do not cover {is_} px')
    NT = pin.tiles_y * pin.tiles_x
    _check(rows, 'rows', torch.float32, (B, F, row), dev)
    _check(pin.entries, 'entries', torch.int32, (pin.entries.numel(),), dev)
    _check(pin.tile_off, 'tile_off', torch.int32, (B * NT + 1,), dev)
    _check(pin.items, 'items', torch.int32, (pin.items.shape[0], 3), dev)
    _check(pin.item_off, 'item_off', torch.int32, (B * NT + 1,), dev)
    return dev, B, F, row


def launch_fwd(source: str, pin: TiledInputs, p: SoftRasParams, with_thr: bool,
               bounds: tuple[int, int, int] = (0, 0, 0)):
    """Launch ``csrc/<source>.cu``'s forward on the current stream.
    ``bounds`` are the threshold's bisection keys and steps.  Returns
    (images, aggrs, counts, thr or None), band-local."""
    dev, B, F, row = check_inputs(pin, p)
    K = p.max_faces_id
    if with_thr and K < 1:
        raise ValueError(f'K must be at least 1, got {K}')
    is_, Hb = p.image_size, band_height(pin)
    images = torch.empty((B, 4, Hb, is_), dtype=torch.float32, device=dev)
    aggrs = torch.empty((B, 2, Hb, is_), dtype=torch.float32, device=dev)
    counts = torch.empty((B, Hb, is_), dtype=torch.int32, device=dev)
    thr = torch.empty((B, Hb, is_), dtype=torch.float32, device=dev) if with_thr else None
    fn = _entry(source, source, _TileFwdArgs)
    args = _TileFwdArgs(
        pin.rows.data_ptr(), pin.entries.data_ptr(), pin.tile_off.data_ptr(),
        images.data_ptr(), aggrs.data_ptr(), counts.data_ptr(),
        None if thr is None else thr.data_ptr(), B, F, row, is_, pin.tile_h, pin.tile_w,
        pin.tiles_x, pin.tiles_y, pin.ty0, pin.ty_band, cuda_impl.chunk_for(row), K,
        *bounds, p.dist_func_id, p.rgb_func_id, p.alpha_func_id, _scalars(p, pin.tex_res))
    _run(fn, source, args, dev)
    return images, aggrs, counts, thr


def launch_bwd(source: str, pin: TiledInputs, images, aggrs, thr, grad_images,
               p: SoftRasParams):
    """Launch ``csrc/<source>.cu``'s backward on the current stream: a
    block per work item.  ``thr`` is the band's threshold map or None (no
    truncation).  Returns rows [E, GC]."""
    dev, B, F, row = check_inputs(pin, p)
    is_, Hb = p.image_size, band_height(pin)
    _check(images, 'images', torch.float32, (B, 4, Hb, is_), dev)
    _check(aggrs, 'aggrs', torch.float32, (B, 2, Hb, is_), dev)
    _check(grad_images, 'grad_images', torch.float32, (B, 4, Hb, is_), dev)
    if thr is not None:
        _check(thr, 'thr', torch.float32, (B, Hb, is_), dev)
    GC = cuda_impl._grad_columns(p, pin.tex_res)
    tex_sums = GC - 9 if p.texture_type_id == 0 else 0
    reserved = 4 * BWD_WARPS * tex_sums
    if cuda_impl.SMEM_BYTES - reserved < 4 * row + 4:
        raise ValueError(f"a face row of {row} floats does not fit the backward kernel's "
                         'shared memory')
    W = pin.items.shape[0]
    grows = torch.empty((pin.entries.numel(), GC), dtype=torch.float32, device=dev)
    if W == 0:
        return grows
    fn = _entry(source, source, _TileBwdArgs)
    args = _TileBwdArgs(
        pin.rows.data_ptr(), pin.entries.data_ptr(), pin.items.data_ptr(), images.data_ptr(),
        aggrs.data_ptr(), grad_images.data_ptr(), None if thr is None else thr.data_ptr(),
        grows.data_ptr(), W, F, row, is_, pin.tile_h, pin.tile_w, pin.tiles_x, pin.tiles_y,
        pin.ty0, Hb, cuda_impl.chunk_for(row, reserved), GC,
        p.dist_func_id, p.rgb_func_id, p.alpha_func_id, _scalars(p, pin.tex_res))
    _run(fn, source, args, dev)
    return grows


def _face_order(pin) -> segment_sum.SegmentOrder:
    """Each face's entries, ascending, as the segment sum reads them."""
    if pin.face_off is None or pin.face_entries is None:
        raise ValueError("the face sum needs each face's entries: prepare with for_grad=True")
    B, F = pin.rows.shape[:2]
    return segment_sum.SegmentOrder(None, pin.face_off, pin.face_entries, B * F)


def _split(total: torch.Tensor, pin, p: SoftRasParams):
    """(grad_face_vertices [B,F,9], grad_textures [B,F,T,3] or [B,F,3,3])
    of the face sums [B*F, GC] (views, no copy)."""
    B, F = pin.rows.shape[:2]
    tex = (B, F, pin.tex_res ** 2, 3) if p.texture_type_id == 0 else (B, F, 3, 3)
    return total[:, :9].reshape(B, F, 9), total[:, 9:].reshape(tex)


def sum_plain(pin, grows: torch.Tensor, p: SoftRasParams):
    """The plain version of the face sum: each face's entry rows [E, GC]
    added in ascending order.  ``pin`` is a route's table (``TiledInputs``
    or ``pxg_impl.PxgInputs``)."""
    return _split(segment_sum.sum_plain(grows, _face_order(pin)), pin, p)


def face_sum(pin, grows: torch.Tensor, p: SoftRasParams):
    """The face sum by device: the segment-sum kernel for CUDA rows (its
    wrapper counts the launch), the plain version for CPU ones."""
    GC = cuda_impl._grad_columns(p, pin.tex_res)
    if grows.dim() != 2 or grows.shape[1] != GC:
        raise ValueError(f'the entry rows must be [E, {GC}], got {tuple(grows.shape)}')
    return _split(segment_sum.segment_sum(grows, _face_order(pin)), pin, p)


# --------------------------------------------------------------------------
# by device
# --------------------------------------------------------------------------

def _device(pin: TiledInputs):
    dev = pin.rows.device
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'soft_rasterize runs on cuda or cpu, not {dev}')
    return dev


def forward(pin: TiledInputs, p: SoftRasParams, with_thr: bool, launch):
    """(images, aggrs, counts, thr or None), band-local: the plain version
    for a CPU input, ``launch`` (the route's counted forward wrapper) for a
    CUDA one."""
    if _device(pin).type == 'cpu':
        return fwd_plain(pin, p, with_thr)
    return launch(pin, p, with_thr)


def backward(pin: TiledInputs, images, aggrs, thr, grad_images, p: SoftRasParams, launch):
    """(grad_face_vertices [B,F,9], grad_textures) of the band's pixels:
    the plain versions for a CPU input, ``launch`` (the route's counted
    backward wrapper) and the face-sum kernel for a CUDA one.  ``thr`` is
    the band's threshold map or None (no truncation)."""
    if _device(pin).type == 'cpu':
        return sum_plain(pin, bwd_rows_plain(pin, images, aggrs, thr, grad_images, p), p)
    return face_sum(pin, launch(pin, images, aggrs, thr, grad_images.contiguous(), p), p)
