"""Deterministic face -> screen-tile binning (plain PyTorch, on the device).

Counterpart of ``jrender_tpu/ops/softras/binning.py`` (``_tile_ranges``,
``emit_pairs``, ``build_tile_lists_compact``, the big-face list and
``report_overflow``).  A face lands in every tile whose pixel-centre
range meets its screen bbox inflated by sqrt(threshold): the same
predicate as the kernel's border check, so binning never changes a
result.

Each face emits at most ``mt`` (tile, face) pairs; one sort of the fused
key tile * stride + face gives every tile a run of ascending face ids.
Faces spanning more than ``mt`` tiles go to the big-face list ``glist``
instead, which the kernel walks for every tile, skipping the tiles
outside a face's tile range.

**No caps.** The JAX package caps each tile's list at 2,048 faces and
the big-face list at 128, and drops (with a warning) what does not fit,
because a Pallas grid needs static shapes.  The CUDA kernel walks a list
of any length, so the port keeps every face: ``glist`` has room for all
F faces and no tile list is cut.  The JAX work-item cap ``w_cap``
(pxt_impl.py:85-104) is an artefact of the static grid and has no
counterpart.  The image equals the oracle's at any density (the JAX
``pxt`` path drops faces where a 256-px tile of the 39,474-face bench
sphere holds more than 2,048).  ``report_overflow`` stays for API parity
and reports zero drops.

**Bands.**  ``band=(ty0, ty_band, ty_stride)`` keeps the pairs of the
tile rows ``ty0 + k * ty_stride``, k < ty_band, only (pixel-band
sharding, ``parallel/render.py``): a pair in another row is not emitted,
as ``prep_pxt`` of the JAX package zeroes the demand of the tiles outside
a device's band (pxt_impl.py:145-157).  The band's tiles keep their runs
unchanged, and the big-face list stays whole (the kernels skip a big face
whose tile range misses a tile), so a band's tile walks are the whole
image's.

No step needs a host synchronisation: every shape here is static in
(B, F, mt, image size).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...utils.profiling import annotate
from .geometry import border_inflation


def mt_for(F: int) -> int:
    """Tile-span emit cap per face (F * mt sorted keys).  Small meshes
    have big faces spanning many tiles, large meshes small ones (the
    JAX package's ``_mt_pxg`` rule)."""
    if F <= 512:
        return 128
    if F <= 8192:
        return 48
    return 12


class CompactLists(NamedTuple):
    """Per-tile face lists in sorted-run form (CSR over the sorted pairs)."""
    faces_sorted: torch.Tensor  # [B, F*mt] i32 face ids sorted by (tile, face)
    starts: torch.Tensor        # [B, NT] i32 offset of each tile's run
    run_counts: torch.Tensor    # [B, NT] i32 run length of each tile
    counts: torch.Tensor        # [B, NT] i32 faces per tile, big faces included
    glist: torch.Tensor         # [B, F] i32 big-face ids, ascending, -1 padded
    gcount: torch.Tensor        # [B] i32 number of valid glist entries
    ranges: torch.Tensor        # [B, F, 4] i32 (ty_min, ty_max, tx_min, tx_max)
    # for the backward's face reduction (``with_inverse``), else None:
    gsrc: torch.Tensor | None = None  # [B, F, mt] i32 place of each emitted
    #                                   pair in faces_sorted, -1 where none
    gpos: torch.Tensor | None = None  # [B, F] i32 place in glist, -1 if not big
    band: tuple[int, int, int] | None = None  # (ty0, ty_band, ty_stride) the pairs
    #                                           were cut to, None: every tile row


def pixel_ranges(face, image_size, threshold):
    """Pixels whose centres lie in each face's bbox inflated by
    sqrt(threshold): (r_min, r_max, c_min, c_max, empty), the bounds
    clamped to [-1, is]."""
    is_ = image_size
    thr = border_inflation(threshold)
    xs = face[..., 0::3]
    ys = face[..., 1::3]
    xmin = xs.amin(-1) - thr
    xmax = xs.amax(-1) + thr
    ymin = ys.amin(-1) - thr
    ymax = ys.amax(-1) + thr

    def index(x):
        # pixel index bounds, clamped to [-1, is] before the int cast so a
        # face near the eye plane cannot overflow it; the clamp changes no
        # emptiness test and no clipped tile range.  NaN counts as empty.
        return torch.nan_to_num(x, nan=float(is_)).clamp(-1, is_).to(torch.int32)

    # pixel centres: xp_c = (2c+1-is)/is, yp_r = (is-1-2r)/is
    c_min = index(torch.ceil((xmin * is_ + is_ - 1) / 2))
    c_max = index(torch.floor((xmax * is_ + is_ - 1) / 2))
    r_min = index(torch.ceil((is_ - 1 - ymax * is_) / 2))
    r_max = index(torch.floor((is_ - 1 - ymin * is_) / 2))
    empty = (c_min > c_max) | (c_max < 0) | (c_min > is_ - 1) \
        | (r_max < 0) | (r_min > is_ - 1)
    return r_min, r_max, c_min, c_max, empty


def _tile_ranges(face, image_size, tile_h, tile_w, threshold):
    """bbox -> clipped tile range per face.  Returns (ty/tx min/max,
    empty, TY, TX); TY and TX round up, so a ragged edge gets its tiles."""
    TY = -(-image_size // tile_h)
    TX = -(-image_size // tile_w)
    r_min, r_max, c_min, c_max, empty = pixel_ranges(face, image_size, threshold)
    tx_min = torch.div(c_min, tile_w, rounding_mode='floor').clamp(0, TX - 1)
    tx_max = torch.div(c_max, tile_w, rounding_mode='floor').clamp(0, TX - 1)
    ty_min = torch.div(r_min, tile_h, rounding_mode='floor').clamp(0, TY - 1)
    ty_max = torch.div(r_max, tile_h, rounding_mode='floor').clamp(0, TY - 1)
    return ty_min, ty_max, tx_min, tx_max, empty, TY, TX


def in_band(ty, band):
    """Whether tile rows ``ty`` (a tensor) lie in ``band`` = (ty0, ty_band,
    ty_stride): ty = ty0 + k * ty_stride with 0 <= k < ty_band."""
    ty0, ty_band, stride = band
    d = ty - ty0
    return (d >= 0) & (d % stride == 0) & (d < ty_band * stride)


def emit_pairs(face, image_size: int, tile_h: int, tile_w: int,
               threshold: float, mt: int, band=None):
    """Each face emits <= mt (tile, face) pairs, row-major over its tile
    range; faces spanning more than mt tiles are big.  With ``band``, the
    pairs outside its tile rows are not emitted (``in_band``).  Returns
    (pair_tile [B,F,mt] with invalid -> n_tiles, pair_ok [B,F,mt],
    big [B,F], stride)."""
    F = face.shape[1]
    ty_min, ty_max, tx_min, tx_max, empty, TY, TX = _tile_ranges(
        face, image_size, tile_h, tile_w, threshold)
    n_tiles = TY * TX
    ntx = (tx_max - tx_min + 1).clamp_min(1)
    ntl = (ty_max - ty_min + 1) * (tx_max - tx_min + 1)
    big = (ntl > mt) & ~empty

    j = torch.arange(mt, dtype=torch.int32, device=face.device)
    dy = torch.div(j, ntx[..., None], rounding_mode='floor')
    dx = j - dy * ntx[..., None]
    pair_tile = (ty_min[..., None] + dy) * TX + (tx_min[..., None] + dx)
    pair_ok = (j < ntl.clamp_max(mt)[..., None]) & (~empty)[..., None] \
        & (~big)[..., None]
    if band is not None:
        pair_ok = pair_ok & in_band(ty_min[..., None] + dy, band)
    pair_tile = torch.where(pair_ok, pair_tile, n_tiles)
    stride = 1 << (F + 1).bit_length()
    return pair_tile, pair_ok, big, stride


def build_tile_lists_compact(face: torch.Tensor, image_size: int, tile_h: int,
                             tile_w: int, threshold: float,
                             mt: int | None = None,
                             with_inverse: bool = False,
                             band: tuple[int, int, int] | None = None) -> CompactLists:
    """face: [B, F, 9] screen-space face vertices.  Emit <= mt pairs per
    face, sort by (tile, face), keep the sorted run and per-tile offsets;
    faces spanning more than mt tiles go to the uncapped glist.

    ``with_inverse`` also returns the inverse of the sort: ``gsrc``, where
    each emitted pair (face, j) landed in ``faces_sorted`` (ascending j is
    ascending tile), and ``gpos``, each big face's place in ``glist``.  The
    backward writes one gradient row per sorted pair and per big face, and
    its reduction gathers a face's rows through these (the analogue of
    ``prep['gsrc']`` of the JAX package's pxt_impl.py).

    ``band`` = (ty0, ty_band, ty_stride) emits the pairs of those tile rows
    only (see the module docstring); the lists then hold the band."""
    with annotate('jr.binning'):
        B, F, _ = face.shape
        mt = mt_for(F) if mt is None else mt
        ty_min, ty_max, tx_min, tx_max, _empty, TY, TX = _tile_ranges(
            face, image_size, tile_h, tile_w, threshold)
        n_tiles = TY * TX
        pair_tile, pair_ok, big, stride = emit_pairs(face, image_size, tile_h, tile_w,
                                                     threshold, mt, band)
        dev = face.device
        fids = torch.arange(F, dtype=torch.int64, device=dev)

        key = (pair_tile.to(torch.int64) * stride + fids[None, :, None]).reshape(B, -1)
        gsrc = gpos = None
        if with_inverse:
            keys_sorted, order = torch.sort(key, dim=1)
            place = torch.empty_like(order)
            place.scatter_(1, order, torch.arange(key.shape[1], device=dev)[None].expand(B, -1))
            gsrc = torch.where(pair_ok.reshape(B, -1), place, -1).to(torch.int32) \
                .reshape(B, F, mt)
            gpos = torch.where(big, big.cumsum(dim=1) - 1, -1).to(torch.int32)
        else:
            keys_sorted = torch.sort(key, dim=1).values
        tiles_s = torch.div(keys_sorted, stride, rounding_mode='floor')
        faces_sorted = (keys_sorted - tiles_s * stride).to(torch.int32)
        bounds = torch.arange(n_tiles + 1, dtype=torch.int64, device=dev)
        edges = torch.searchsorted(tiles_s.contiguous(),
                                   bounds[None].expand(B, -1).contiguous())
        starts = edges[:, :-1].to(torch.int32)
        run_counts = (edges[:, 1:] - edges[:, :-1]).to(torch.int32)

        # big-face list: ascending ids, compacted to the front, -1 padded
        gcount = big.sum(dim=1, dtype=torch.int32)
        order = torch.sort(torch.where(big, fids[None], F + fids[None]), dim=1).values
        glist = torch.where(order < F, order, -1).to(torch.int32)

        # big faces per tile: 2-D difference array over each big face's range
        ranges = torch.stack([ty_min, ty_max, tx_min, tx_max], dim=-1)
        diff = torch.zeros((B, (TY + 1) * (TX + 1)), dtype=torch.int32, device=dev)
        one = big.to(torch.int32)
        for ty, tx, sgn in ((ty_min, tx_min, 1), (ty_min, tx_max + 1, -1),
                            (ty_max + 1, tx_min, -1), (ty_max + 1, tx_max + 1, 1)):
            diff.scatter_add_(1, (ty * (TX + 1) + tx).to(torch.int64), sgn * one)
        gt = diff.reshape(B, TY + 1, TX + 1).cumsum(1).cumsum(2)[:, :TY, :TX]
        counts = run_counts + gt.reshape(B, n_tiles).to(torch.int32)
        return CompactLists(
            faces_sorted=faces_sorted, starts=starts, run_counts=run_counts,
            counts=counts, glist=glist, gcount=gcount,
            ranges=ranges.to(torch.int32).contiguous(), gsrc=gsrc, gpos=gpos,
            band=None if band is None else tuple(int(v) for v in band))


def tile_list(cl: CompactLists, b: int, tile: int, tiles_x: int):
    """Face ids of one tile, as the kernel walks them: the big faces whose
    range holds the tile, then the tile's sorted run (a debugging and
    test helper; the kernel does the same walk on the device)."""
    ty, tx = divmod(tile, tiles_x)
    g = cl.glist[b, :int(cl.gcount[b])].long()
    r = cl.ranges[b, g]
    hit = (r[:, 0] <= ty) & (ty <= r[:, 1]) & (r[:, 2] <= tx) & (tx <= r[:, 3])
    s = int(cl.starts[b, tile])
    run = cl.faces_sorted[b, s:s + int(cl.run_counts[b, tile])]
    return torch.cat([g[hit].to(torch.int32), run])


def report_overflow(cl: CompactLists, where: str = 'softras') -> None:
    """Kept for API parity with the JAX package, where static caps can drop
    faces; the port keeps every face, so there is never anything to report."""
