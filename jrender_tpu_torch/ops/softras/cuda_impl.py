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

The forward and the threshold split each tile's face list over a cluster
of FWD_SPLIT blocks and merge their partial states (the threshold: the
ranks' K-smallest lists or bisection counts) in rank order;
``fwd_split_plain`` and ``thr_split_plain`` are the plain versions of
those splits and merges.  The backward splits each tile's
run over BWD_SPLIT blocks, whose gradient rows need no merge.

Bands.  ``prepare(..., band=(ty0, ty_band, ty_stride))`` keeps the tile
rows ty0 + k * ty_stride, k < ty_band (``ty_stride`` 1: a contiguous band),
the counterpart of the band arguments of ``soft_rasterize_fwd_pxt`` and
``soft_rasterize_bwd_pxt`` for pixel-band sharding
(``jrender_tpu/parallel/render.py``): the binning emits the band's pairs
only, the forward and the threshold launch a grid of the band's tile rows
and write band-local maps [B, C, band_h, W] (``band_rows``: band row i is
image row ``band_rows(...)[i]``) with the pixel centres of the image rows,
and the backward reads the band's maps and returns the gradient of the
band's pixels, its big-face kernel walking only the band's rows of a big
face's box.  A tile's walk is the same in any band, so a band's maps and
slot rows are the whole image's, bit for bit.  Without a band the call is
the band (0, tiles, 1).

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
from ...utils.profiling import annotate
from . import binning, torch_impl
from . import geometry as G
from .params import SoftRasParams

TILE = 16                     # screen tile = one block of TILE x TILE threads
MAX_CHUNK = 64                # faces staged in shared memory at once
SMEM_BYTES = 48 * 1024        # a block's static shared-memory budget
SMEM_MAX_BYTES = 227 * 1024   # the most shared memory an H100 block can ask for
ROW_BASE = 31                 # face 9, inv 9, sym 9, obt 3, front 1
FWD_SPLIT = 8                 # blocks sharing a tile's list (kSplit of softras_fwd.cu)
BWD_SPLIT = 8                 # blocks sharing a tile's run (kSplit of softras_bwd.cu)
THR_LIST_MAX = 32             # K the threshold kernel keeps a list for (kListMax); past it, bisects


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
            'dist_func', 'rgb_func', 'alpha_func', 'ty0', 'ty_band', 'ty_stride',
            'band_h')] + [('s', _Scalars)]


class _ThrArgs(ctypes.Structure):
    """Mirror of ``softras::ThrArgs`` in csrc/softras_thr.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        'rows', 'faces_sorted', 'starts', 'run_counts', 'glist', 'gcount',
        'ranges', 'counts', 'thr')] + \
        [(n, ctypes.c_int) for n in (
            'B', 'F', 'L', 'row', 'image_size', 'tiles_x', 'tiles_y', 'chunk',
            'dist_func', 'K', 'ty0', 'ty_band', 'ty_stride', 'band_h')] + [('s', _Scalars)]


class _BwdArgs(ctypes.Structure):
    """Mirror of ``softras::BwdArgs`` in csrc/softras_bwd.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        'rows', 'faces_sorted', 'starts', 'run_counts', 'glist', 'gcount',
        'image', 'aggrs', 'grad', 'thr', 'gslots', 'gbig')] + \
        [(n, ctypes.c_int) for n in (
            'B', 'F', 'L', 'row', 'image_size', 'tiles_x', 'tiles_y', 'chunk',
            'GC', 'dist_func', 'rgb_func', 'alpha_func', 'ty0', 'ty_band', 'ty_stride',
            'band_h')] + [('s', _Scalars)]


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


def bwd_reserved_bytes(tex_sums: int) -> int:
    """Shared memory a backward block holds besides its face rows: the
    tile's pixel maps (11 floats per pixel) and, for surface textures, 3T
    texel sums per warp (``tex_sums`` floats, 0 for vertex colours)."""
    return 4 * (11 * TILE * TILE + (TILE * TILE // 32) * tex_sums)


def staged_chunk(row: int, reserved_bytes: int = 0) -> int:
    """Faces per chunk of a kernel that stages two chunks of rows of
    ``row`` floats and one int per face at once (the binned forward and
    backward) besides ``reserved_bytes`` of its own: as many as fit
    SMEM_BYTES, at most MAX_CHUNK, at least one.  A block whose one face
    does not fit SMEM_BYTES asks the card for more (the launchers raise the
    kernel's limit); past a block's SMEM_MAX_BYTES this raises."""
    per_face = 2 * (4 * row + 4)
    if reserved_bytes + per_face > SMEM_MAX_BYTES:
        raise ValueError(f'a face row of {row} floats does not fit a block\'s shared memory')
    return max(1, min(MAX_CHUNK, (SMEM_BYTES - reserved_bytes) // per_face))


def full_band(image_size: int) -> tuple[int, int, int]:
    """The band of every tile row: (0, tiles, 1)."""
    return 0, -(-image_size // TILE), 1


def check_band(band, image_size: int) -> tuple[int, int, int]:
    """``band`` as (ty0, ty_band, ty_stride) ints; raises unless its rows
    lie in the image's tile rows."""
    ty0, ty_band, stride = (int(v) for v in band)
    tiles = -(-image_size // TILE)
    if not (0 <= ty0 and ty_band >= 1 and stride >= 1
            and ty0 + (ty_band - 1) * stride < tiles):
        raise ValueError(f'the band ({ty0}, {ty_band}, {stride}) does not lie in the '
                         f'{tiles} tile rows of the image')
    return ty0, ty_band, stride


def band_rows(image_size: int, band=None, tile: int = TILE) -> torch.Tensor:
    """The image rows of ``band``'s maps, in their order: band row
    k * tile + i is image row (ty0 + k * ty_stride) * tile + i (rows past
    a ragged edge dropped).  [band_h] int64 on the CPU."""
    ty0, ty_band, stride = full_band(image_size) if band is None else band
    tiles = ty0 + stride * torch.arange(ty_band)
    rows = (tiles[:, None] * tile + torch.arange(tile)[None]).reshape(-1)
    return rows[rows < image_size]


def band_height(image_size: int, band) -> int:
    """Rows of ``band``'s maps: ``band_rows(image_size, band).numel()``
    (only the band's last tile row can pass a ragged edge)."""
    ty0, ty_band, stride = band
    return (ty_band - 1) * TILE + min(TILE, image_size - (ty0 + (ty_band - 1) * stride) * TILE)


def input_band(inputs: FwdInputs, p: SoftRasParams) -> tuple[int, int, int]:
    """The band the inputs' lists hold (``full_band`` without one)."""
    band = inputs.lists.band
    return full_band(p.image_size) if band is None else band


def prepare(face_vertices: torch.Tensor, textures: torch.Tensor,
            p: SoftRasParams, for_grad: bool = False, tile_h: int = TILE,
            tile_w: int = TILE, band=None) -> FwdInputs:
    """Binning (``tile_h`` x ``tile_w`` tiles) and per-face rows for the
    kernels; plain torch on the device.  ``for_grad`` adds the inverse of
    the binning's sort, which the backward's face reduction gathers
    through.  ``band`` = (ty0, ty_band, ty_stride) keeps those 16-px tile
    rows only (see the module docstring)."""
    B, F = face_vertices.shape[:2]
    face = face_vertices.reshape(B, F, 9)
    if p.texture_type_id == 0:
        T = textures.shape[2]
        R = math.isqrt(T)
        if R * R != T:
            raise ValueError(f'surface textures need T = R*R texels, got T={T}')
    else:
        R = 1
    if band is not None:
        if (tile_h, tile_w) != (TILE, TILE):
            raise ValueError('a band is one of the binned route\'s 16-px tile rows')
        band = check_band(band, p.image_size)
    lists = binning.build_tile_lists_compact(face, p.image_size, tile_h, tile_w,
                                             p.threshold, with_inverse=for_grad, band=band)
    return FwdInputs(face_rows(face, textures, p), lists, R)


def _need_cuda(dev: torch.device) -> None:
    """Raise unless ``dev`` is a CUDA card: the kernels' arguments point
    into its memory."""
    if dev.type != 'cuda':
        raise ValueError(f'the CUDA kernel needs CUDA tensors, got {dev}')


def _check(t: torch.Tensor, what: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f'{what} is on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise TypeError(f'{what} must be {dtype}, got {t.dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{what} must have shape {tuple(shape)}, got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{what} must be contiguous')


def _c_int(lib, name: str) -> int:
    fn = getattr(lib, name)
    fn.argtypes = []
    fn.restype = ctypes.c_int
    return fn()


def _entry(source: str, name: str, args_type, split: int | None = None, lib=None):
    """The C entry point ``name`` of ``csrc/<source>.cu`` (of ``lib``,
    else built on first use); raises if its argument struct is laid out
    otherwise than here, or if the blocks it splits a tile over (its
    ``<name>_split``) are not ``split``."""
    lib = lib or _build.load(source)
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.POINTER(args_type), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if _c_int(lib, f'{name}_args_size') != ctypes.sizeof(args_type):
        raise RuntimeError(f'{args_type.__name__[1:]} layout differs between '
                           f'Python and CUDA')
    if split is not None and _c_int(lib, f'{name}_split') != split:
        raise RuntimeError(f'{name} splits a tile over {_c_int(lib, f"{name}_split")} '
                           f'blocks, the wrapper over {split}')
    return fn


def _run(fn, name: str, args, dev) -> None:
    """Call a kernel's entry point on the current stream, in the span
    ``jr.kernel.<name>``; raise on a refused launch (-1: the forward's
    cluster cannot be resident)."""
    with annotate('jr.kernel.' + name):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.byref(args), ctypes.c_void_p(stream))
    if err != 0:
        why = ("a cluster of the kernel's blocks cannot be resident on one GPC"
               if err == -1 else f'CUDA error {err}')
        raise RuntimeError(f'{name} kernel launch failed: {why}')


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
    _need_cuda(dev)
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


def _band_args(inputs: FwdInputs, p: SoftRasParams):
    """(ty0, ty_band, ty_stride, band_h) of the inputs' band."""
    band = input_band(inputs, p)
    return (*band, band_height(p.image_size, band))


def fwd_args(inputs: FwdInputs, p: SoftRasParams):
    """The forward kernel's checked arguments and its outputs (images
    [B,4,Hb,W], aggrs [B,2,Hb,W], counts [B,Hb,W] int32: the maps of the
    inputs' band, Hb = H without one), allocated on the inputs' card: what
    ``launch`` hands to the kernel."""
    dev, B, F, row, L, tiles = _check_inputs(inputs, p)
    rows, cl, R = inputs
    is_ = p.image_size
    band = _band_args(inputs, p)
    Hb = band[3]
    images = torch.empty((B, 4, Hb, is_), dtype=torch.float32, device=dev)
    aggrs = torch.empty((B, 2, Hb, is_), dtype=torch.float32, device=dev)
    counts = torch.empty((B, Hb, is_), dtype=torch.int32, device=dev)
    args = _FwdArgs(
        rows.data_ptr(), cl.faces_sorted.data_ptr(), cl.starts.data_ptr(),
        cl.run_counts.data_ptr(), cl.glist.data_ptr(), cl.gcount.data_ptr(),
        cl.ranges.data_ptr(), images.data_ptr(), aggrs.data_ptr(),
        counts.data_ptr(), B, F, L, row, is_, tiles, tiles, staged_chunk(row),
        p.dist_func_id, p.rgb_func_id, p.alpha_func_id, *band, _scalars(p, R))
    return args, (images, aggrs, counts)


def launch(inputs: FwdInputs, p: SoftRasParams):
    """Launch the CUDA forward kernel on the current stream.

    Returns (images [B,4,Hb,W], aggrs [B,2,Hb,W], counts [B,Hb,W] int32),
    the maps of the inputs' band (Hb = H without one).
    ``launch.launches`` counts the launches.
    """
    args, out = fwd_args(inputs, p)
    fn = _entry('softras_fwd', 'softras_fwd', _FwdArgs, FWD_SPLIT)
    _run(fn, 'softras_fwd', args, inputs.rows.device)
    launch.launches += 1
    return out


launch.launches = 0


def split_variant(name: str, split: int):
    """The entry point of ``softras_fwd``, ``softras_thr`` or
    ``softras_bwd`` built with another number of blocks per tile (the
    kernel's SOFTRAS_FWD_SPLIT, which the threshold shares, or
    SOFTRAS_BWD_SPLIT), to time the alternatives to FWD_SPLIT and
    BWD_SPLIT; call it with ``fwd_args``, ``thr_args`` or ``bwd_args``
    through ``_run``.  The wrappers launch the default build only."""
    macro, args_type = {'softras_fwd': ('SOFTRAS_FWD_SPLIT', _FwdArgs),
                        'softras_thr': ('SOFTRAS_FWD_SPLIT', _ThrArgs),
                        'softras_bwd': ('SOFTRAS_BWD_SPLIT', _BwdArgs)}[name]
    return _entry(name, name, args_type, split, _build.load(name, ((macro, split),)))


def rank_shares(total: int, split: int):
    """The shares [lo, hi) of a tile's sequence of ``total`` face ids (its
    big faces, then its run) that the ranks of a split kernel walk (the
    binned forward and threshold, the f_px and px_f forwards): rank r takes
    [r * per, (r + 1) * per) with per = ceil(total / split); ranks past the
    end take none."""
    per = -(-total // split)
    return [(r * per, min(total, (r + 1) * per)) for r in range(split) if r * per < total]


def _share_items(inputs: FwdInputs, p: SoftRasParams, split: int):
    """The ranks' shares of every tile's sequence as pxg work items: each
    tile's sequence cut by ``rank_shares``, a big face whose tile range
    misses the tile skipped (as the kernels skip it), a share left without
    a face dropped; the tiles outside the inputs' band get no items.
    Returns ``pxg_impl.PxgInputs`` (no face entries)."""
    from . import pxg_impl           # pxg_impl imports this module
    rows, cl, R = inputs
    B, F = rows.shape[:2]
    tiles = -(-p.image_size // TILE)
    NT = tiles * tiles
    ty0, ty_band, stride = input_band(inputs, p)
    band_tiles = set(range(ty0, ty0 + ty_band * stride, stride))
    entries, items, item_off = [], [], [0]
    for b in range(B):
        big = cl.glist[b, :int(cl.gcount[b])].tolist()
        rg = cl.ranges[b].tolist()
        for t in range(NT):
            ty, tx = divmod(t, tiles)
            if ty not in band_tiles:
                item_off.append(len(items))
                continue
            start, run = int(cl.starts[b, t]), int(cl.run_counts[b, t])
            seq = [g if rg[g][0] <= ty <= rg[g][1] and rg[g][2] <= tx <= rg[g][3] else -1
                   for g in big] + cl.faces_sorted[b, start:start + run].tolist()
            for lo, hi in rank_shares(len(seq), split):
                ids = [f for f in seq[lo:hi] if f >= 0]
                if ids:
                    items.append((b * NT + t, len(entries), len(entries) + len(ids)))
                    entries += ids
            item_off.append(len(items))
    dev = rows.device

    def i32(x, shape=(-1,)):
        return torch.tensor(x, dtype=torch.int32, device=dev).reshape(shape)

    return pxg_impl.PxgInputs(rows, i32(entries), None, i32(items, (-1, 3)), i32(item_off),
                              None, None, R)


def fwd_split_plain(inputs: FwdInputs, p: SoftRasParams, split: int = FWD_SPLIT):
    """The plain version of the forward kernel's split and merge: each
    tile's sequence cut into the ranks' shares (``_share_items``), each
    share aggregated without the background by the pxg partials' plain
    version, the shares merged in rank order by the pxg combine's plain
    version (``pxg_impl.fwd_partials_plain``, ``combine_plain``), on the
    tiles of the inputs' band.  Returns what ``launch`` returns: the band's
    maps."""
    from . import pxg_impl
    pin = _share_items(inputs, p, split)
    parts, _ = pxg_impl.fwd_partials_plain(pin, p, with_thr=False)
    rows = band_rows(p.image_size, input_band(inputs, p)).to(parts.device)
    return tuple(m.index_select(-2, rows) for m in pxg_impl.combine_plain(pin, parts, p))


def thr_split_plain(inputs: FwdInputs, counts: torch.Tensor, p: SoftRasParams,
                    split: int = FWD_SPLIT):
    """The plain version of the threshold kernel's split and merge: each
    tile's sequence cut into the ranks' shares (``_share_items``), each
    share's K smallest candidate depths per pixel (the pxg partials' plain
    version), the K-th smallest of their union where ``counts`` (the
    forward's count map) is over K, else ``far`` (``pxg_impl.thr_plain``:
    the K smallest of a union lie among the K smallest of each part), on
    the tiles of the inputs' band (``counts`` and the result are its maps).
    Returns what ``launch_thr`` returns."""
    from . import pxg_impl
    pin = _share_items(inputs, p, split)
    _, depths = pxg_impl.fwd_partials_plain(pin, p, with_thr=True)
    is_ = p.image_size
    rows = band_rows(is_, input_band(inputs, p)).to(counts.device)
    whole = counts.new_zeros((counts.shape[0], is_, is_))
    whole[:, rows] = counts
    return pxg_impl.thr_plain(pin, depths, whole, p).index_select(-2, rows)


def thr_chunk(K: int) -> int:
    """Faces per staged chunk of the threshold kernel: two chunks of 31
    floats and an id per face beside the block's K-smallest lists
    ((K + 1) x 256 values, K <= 32) or its two count buffers, within
    SMEM_BYTES."""
    own = 4 * (K + 1) * TILE * TILE if K <= THR_LIST_MAX else 8 * TILE * TILE
    return min(MAX_CHUNK, (SMEM_BYTES - own) // (2 * 4 * (ROW_BASE + 1)))


def thr_args(inputs: FwdInputs, counts: torch.Tensor, p: SoftRasParams):
    """The threshold kernel's checked arguments and its output thr
    [B,Hb,W] (the inputs' band, as ``counts``), allocated on the inputs'
    card: what ``launch_thr`` hands to the kernel."""
    dev, B, F, row, L, tiles = _check_inputs(inputs, p)
    rows, cl, R = inputs
    is_ = p.image_size
    if p.max_faces_id < 1:
        raise ValueError(f'K must be at least 1, got {p.max_faces_id}')
    band = _band_args(inputs, p)
    Hb = band[3]
    _check(counts, 'counts', torch.int32, (B, Hb, is_), dev)
    thr = torch.empty((B, Hb, is_), dtype=torch.float32, device=dev)
    args = _ThrArgs(
        rows.data_ptr(), cl.faces_sorted.data_ptr(), cl.starts.data_ptr(),
        cl.run_counts.data_ptr(), cl.glist.data_ptr(), cl.gcount.data_ptr(),
        cl.ranges.data_ptr(), counts.data_ptr(), thr.data_ptr(),
        B, F, L, row, is_, tiles, tiles, thr_chunk(p.max_faces_id),
        p.dist_func_id, p.max_faces_id, *band, _scalars(p, R))
    return args, thr


def launch_thr(inputs: FwdInputs, counts: torch.Tensor, p: SoftRasParams):
    """Launch the top-K threshold kernel on the current stream: thr
    [B,Hb,W] (the inputs' band), the K-th smallest candidate depth of each pixel (K =
    ``p.max_faces_id``) and ``far`` where ``counts`` (the forward's
    candidate count map) is at most K.  Like the forward it splits each
    tile's list over a cluster of FWD_SPLIT blocks; ``thr_split_plain`` is
    the plain version of that split and merge.  ``launch_thr.launches``
    counts the launches."""
    args, thr = thr_args(inputs, counts, p)
    fn = _entry('softras_thr', 'softras_thr', _ThrArgs, FWD_SPLIT)
    _run(fn, 'softras_thr', args, inputs.rows.device)
    launch_thr.launches += 1
    return thr


launch_thr.launches = 0


def _grad_columns(p: SoftRasParams, R: int) -> int:
    """Values of one gradient row: 9 face coordinates and the textures."""
    return 9 + (3 * R * R if p.texture_type_id == 0 else 9)


def bwd_args(inputs: FwdInputs, images, aggrs, thr, grad_images, p: SoftRasParams):
    """The backward kernels' checked arguments and their output rows,
    allocated on the inputs' card: what ``launch_bwd`` hands to them.  The
    maps are the inputs' band's [B, C, Hb, W]."""
    dev, B, F, row, L, tiles = _check_inputs(inputs, p)
    rows, cl, R = inputs
    is_ = p.image_size
    band = _band_args(inputs, p)
    Hb = band[3]
    _check(images, 'images', torch.float32, (B, 4, Hb, is_), dev)
    _check(aggrs, 'aggrs', torch.float32, (B, 2, Hb, is_), dev)
    _check(grad_images, 'grad_images', torch.float32, (B, 4, Hb, is_), dev)
    if thr is not None:
        _check(thr, 'thr', torch.float32, (B, Hb, is_), dev)
    GC = _grad_columns(p, R)
    tex_sums = GC - 9 if p.texture_type_id == 0 else 0
    out = GradRows(torch.empty((B, L, GC), dtype=torch.float32, device=dev),
                   torch.empty((B, F, GC), dtype=torch.float32, device=dev))
    args = _BwdArgs(
        rows.data_ptr(), cl.faces_sorted.data_ptr(), cl.starts.data_ptr(),
        cl.run_counts.data_ptr(), cl.glist.data_ptr(), cl.gcount.data_ptr(),
        images.data_ptr(), aggrs.data_ptr(), grad_images.data_ptr(),
        None if thr is None else thr.data_ptr(), out.gslots.data_ptr(),
        out.gbig.data_ptr(), B, F, L, row, is_, tiles, tiles,
        staged_chunk(row, bwd_reserved_bytes(tex_sums)), GC,
        p.dist_func_id, p.rgb_func_id, p.alpha_func_id, *band, _scalars(p, R))
    return args, out


def launch_bwd(inputs: FwdInputs, images, aggrs, thr, grad_images,
               p: SoftRasParams) -> GradRows:
    """Launch the backward kernels on the current stream: the per-tile
    kernel writes one gradient row per sorted (tile, face) pair, the
    big-face kernel one row per face of the big-face list.  ``thr`` is the
    threshold map or None (no truncation).  ``launch_bwd.launches`` counts
    the calls."""
    args, out = bwd_args(inputs, images, aggrs, thr, grad_images, p)
    fn = _entry('softras_bwd', 'softras_bwd', _BwdArgs, BWD_SPLIT)
    _run(fn, 'softras_bwd', args, inputs.rows.device)
    launch_bwd.launches += 1
    return out


launch_bwd.launches = 0


def reduce_args(inputs: FwdInputs, grad_rows: GradRows, p: SoftRasParams):
    """The face reduction's checked arguments and its outputs
    (grad_face_vertices [B,F,9], grad_textures [B,F,T,3] or [B,F,3,3]),
    allocated on the inputs' card: what ``launch_reduce`` hands to the
    kernel."""
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
    args = _ReduceArgs(grad_rows.gslots.data_ptr(), grad_rows.gbig.data_ptr(),
                       cl.gsrc.data_ptr(), cl.gpos.data_ptr(),
                       grad_face.data_ptr(), grad_tex.data_ptr(), B, F, L, mt, GC)
    return args, (grad_face, grad_tex)


def launch_reduce(inputs: FwdInputs, grad_rows: GradRows, p: SoftRasParams):
    """Launch the face reduction on the current stream: each face's rows
    summed in ascending tile order (or its big-face row taken).  Returns
    (grad_face_vertices [B,F,9], grad_textures [B,F,T,3] or [B,F,3,3]).
    ``launch_reduce.launches`` counts the launches."""
    args, out = reduce_args(inputs, grad_rows, p)
    _run(_entry('softras_bwd', 'softras_bwd_reduce', _ReduceArgs), 'softras_bwd_reduce', args,
         inputs.rows.device)
    launch_reduce.launches += 1
    return out


launch_reduce.launches = 0


def reduce_rows_plain(inputs: FwdInputs, grad_rows: GradRows, p: SoftRasParams):
    """The plain version of the face reduction: each face's rows added
    through ``gsrc`` in ascending tile order from 0, as the kernel adds
    them (a face's sum is never -0, so adding 0 for a pair not emitted
    changes no bit: the kernel's bits), or the face's big-face row taken.
    With a band, the pairs outside it were not emitted: the sum is the
    band's.
    Returns what ``launch_reduce`` returns."""
    cl, R = inputs.lists, inputs.tex_res
    B, F, mt = cl.gsrc.shape
    gsrc, gpos = cl.gsrc.long(), cl.gpos.long()
    b = torch.arange(B, device=gsrc.device)[:, None]
    total = grad_rows.gbig.new_zeros(grad_rows.gbig.shape)
    for j in range(mt):
        sl = gsrc[:, :, j]
        total = total + torch.where((sl >= 0)[..., None], grad_rows.gslots[b, sl.clamp_min(0)],
                                    0.0)
    total = torch.where((gpos >= 0)[..., None],
                        grad_rows.gbig[b, gpos.clamp_min(0)], total)
    tex_shape = (B, F, R * R, 3) if p.texture_type_id == 0 else (B, F, 3, 3)
    return total[..., :9].contiguous(), total[..., 9:].reshape(tex_shape)


def bwd_rows_plain(inputs: FwdInputs, images, aggrs, thr, grad_images,
                   p: SoftRasParams) -> GradRows:
    """The plain version of the backward kernels' rows on the inputs' band
    (maps [B, C, Hb, W] of the band): each sorted pair's slot row, its
    face's gradient summed over its tile's pixels, and each big face's row
    of ``gbig``, its gradient over the band's pixels
    (``torch_impl.backward_single``: a pixel outside a face's inflated
    box adds nothing).  Rows of pairs the binning did not emit stay 0.
    Returns what ``launch_bwd`` returns."""
    rows, cl, R = inputs
    B, F = rows.shape[:2]
    dev = rows.device
    is_ = p.image_size
    tiles = -(-is_ // TILE)
    ty0, ty_band, stride = input_band(inputs, p)
    image_rows = band_rows(is_, (ty0, ty_band, stride)).to(dev)
    Hb = image_rows.numel()
    GC = _grad_columns(p, R)
    out = GradRows(rows.new_zeros((B, cl.faces_sorted.shape[1], GC)),
                   rows.new_zeros((B, F, GC)))

    def face_rows_of(b, ids, lr, cc):
        """[n, GC]: the gradients of faces ``ids`` over band rows ``lr``,
        columns ``cc`` (pixels, flattened)."""
        r = rows[b, ids.long()]
        n = ids.numel()
        tex = r[:, ROW_BASE:].reshape((n, R * R, 3) if p.texture_type_id == 0 else (n, 3, 3))
        xp, yp = torch_impl.pixel_centers(image_rows[lr], cc, is_)

        def at(x):
            return x[b][:, lr, cc].T

        gf, gt = torch_impl.backward_single(
            r[:, :9], tex, at(images), at(aggrs), at(grad_images), p, xp, yp,
            None if thr is None else thr[b, lr, cc], ids=ids, n_faces=F)
        return torch.cat([gf, gt.reshape(n, -1)], dim=1)

    pix = torch.arange(TILE, device=dev)
    for b in range(B):
        for k in range(ty_band):
            lr = k * TILE + pix
            lr = lr[lr < Hb]
            for tx in range(tiles):
                t = (ty0 + k * stride) * tiles + tx
                start, run = int(cl.starts[b, t]), int(cl.run_counts[b, t])
                if run == 0:
                    continue
                cc = tx * TILE + pix
                cc = cc[cc < is_]
                lg, cg = torch.meshgrid(lr, cc, indexing='ij')
                out.gslots[b, start:start + run] = face_rows_of(
                    b, cl.faces_sorted[b, start:start + run], lg.reshape(-1), cg.reshape(-1))
        nb = int(cl.gcount[b])
        if nb:
            lg, cg = torch.meshgrid(torch.arange(Hb, device=dev),
                                    torch.arange(is_, device=dev), indexing='ij')
            out.gbig[b, :nb] = face_rows_of(b, cl.glist[b, :nb], lg.reshape(-1),
                                            cg.reshape(-1))
    return out


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
