"""SoftRas over grouped work items: the ``pxg`` route.

Counterpart of ``jrender_tpu/ops/softras/pxg_impl.py`` (``prep_pxg`` :149,
``_make_fwd_kernel_pxg`` :314, ``_combine_pxg`` :449, the overfull-tile
threshold ``_thr_from_depths`` :616 with ``_make_thr_kernel_pxg`` :545,
``soft_rasterize_fwd_pxg`` :678, ``_make_bwd_kernel_pxg`` :758 and
``soft_rasterize_bwd_pxg`` :941), taken where ``JR_LAYOUT=pxg``
(``route.py``).  It computes what the binned route computes, with each
tile's face list cut into work items that run in blocks of their own.

Work items.  The binned route's binning (``binning.build_tile_lists_compact``
at 16 x 16 pixels, the JAX package's ``_mt_pxg`` emit rule) gives every
screen tile its list: the big faces whose tile range holds the tile,
ascending, then the tile's sorted run.  The prep writes the lists out tile
after tile (``entries``), big faces included, and cuts each into work
items of at most ``group`` faces (GROUP = 64).  A block of the forward
kernel stages up to 64 face rows in shared memory at once
(``cuda_impl.MAX_CHUNK``), so an item of 64 faces is one staging round; at
1024 px on the 39,474-face sphere a mean tile of 127 faces makes two items
and the busiest, 1,158 faces, 19.  A smaller group adds partial rows and
combine work for every tile; a larger one leaves the long lists to few
blocks.  The prep's one host synchronisation reads the sizes (entries,
items, big-face pairs) so that every kernel's grid is exact.

**No caps.** The JAX package caps a tile's list at
``min(F, 2048)`` faces, sizes its grid for the worst case
(``_wg_cap_pxg``, the glist slack) and clamps its dynamic grid
(``pxg_impl.py:131-147``, :236-246); the port keeps every face and makes
exactly the items the lists need, so none of that has a counterpart.
``JR_PXG_TILE`` and ``JR_PXG_MT`` are knobs of the TPU layout and have no
counterpart either: the tiles are 16 x 16 at any size (a ragged last tile
is masked, as on the binned route) and the emit cap is ``binning.mt_for``.
Pixel centres are the plain version's ``(2c+1-is)/is``; the TPU layout's
per-tile base plus offset can differ by an ulp at sizes that are not
powers of two.

Kernels and wrappers (each wrapper counts its launches in ``.launches``):
  ``launch_pxg_fwd``      csrc/softras_pxg_fwd.cu  partial aggregates per item
                                                   and pixel, and the K smallest
                                                   candidate depths when asked
  ``launch_pxg_combine``  csrc/softras_pxg_fwd.cu  the partials merged per tile:
                                                   image, aggregates, counts
  ``launch_pxg_thr``      csrc/softras_pxg_thr.cu  the top-K threshold on the
                                                   tiles where a pixel has more
                                                   than K candidates
  ``launch_pxg_bwd``      csrc/softras_pxg_bwd.cu  one gradient row per entry
                                                   (tile, face) of every item
Each face's rows are then summed in tile order by ``tiled.face_sum`` (the
segment sum, csrc/segment_sum.cu), which the f_px and px_f routes share,
as they share ``tiled.tile_work``, which writes the lists out.

The plain versions beside them (``fwd_partials_plain``, ``combine_plain``,
``thr_plain``, ``bwd_rows_plain``, ``bwd_plain``; the face sum's is
``tiled.sum_plain``) are built on ``torch_impl``.  ``forward`` and
``backward`` go by the device of their input: a CPU tensor takes the plain
versions, a CUDA tensor the kernels.  There is no fallback: a CUDA input
launches the kernels or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import cuda_impl, tiled, torch_impl
from . import geometry as G
from .cuda_impl import ROW_BASE, TILE, _Scalars, _check, _entry, _run, _scalars
from .params import SoftRasParams

GROUP = 64            # most faces of one work item
PARTS = 8             # channels of a partial row (see ``fwd_partials_plain``)
PIXELS = TILE * TILE  # pixels of a tile, (ly, lx) at ly * 16 + lx
LIST_MAX = 32         # the forward keeps per-item depth lists for K up to this
NO_MAX = -1e30        # the softmax maximum of an item without a candidate


class PxgInputs(NamedTuple):
    """What the pxg kernels read.  A global tile is b * NT + t."""
    rows: torch.Tensor                  # [B, F, 31 + 3T] f32 (cuda_impl.face_rows)
    entries: torch.Tensor               # [E] i32 face ids of every tile's list, tile
    #                                     after tile: its big faces, then its run
    tile_off: torch.Tensor              # [B*NT + 1] i32 first entry of each tile
    items: torch.Tensor                 # [W, 3] i32 (global tile, first entry, end)
    item_off: torch.Tensor              # [B*NT + 1] i32 first item of each tile
    face_off: torch.Tensor | None       # [B*F + 1] i32 first place of each face in
    face_entries: torch.Tensor | None   # [E] i32: its entries, ascending (for_grad)
    tex_res: int                        # R, T = R * R (1 for vertex colours)


def tiles_for(image_size: int) -> int:
    """Tiles per side: 16-px tiles, the last one ragged."""
    return -(-image_size // TILE)


def prep_pxg(face_vertices: torch.Tensor, textures: torch.Tensor, p: SoftRasParams,
             for_grad: bool = False, group: int = GROUP) -> PxgInputs:
    """Rows, tile lists and work items of the pxg route, plain torch on the
    device of the input.  ``for_grad`` adds each face's entries, which the
    backward's face sum walks."""
    B, F = face_vertices.shape[:2]
    base = cuda_impl.prepare(face_vertices, textures, p)
    tiles = tiles_for(p.image_size)
    work = tiled.tile_work(base.lists, B, F, tiles, tiles, group, for_grad)
    return PxgInputs(base.rows, *work, base.tex_res)


def _shape(pin: PxgInputs, p: SoftRasParams):
    """(B, F, tiles per side, NT)."""
    B, F = pin.rows.shape[:2]
    tiles = tiles_for(p.image_size)
    return B, F, tiles, tiles * tiles


def _tile_pixels(tile_g: torch.Tensor, NT: int, tiles: int, is_: int):
    """(row, col) [n, 256] of the pixels of global tiles [n] and whether
    each lies in the image."""
    t = tile_g % NT
    pix = torch.arange(PIXELS, device=tile_g.device)
    r = (t // tiles)[:, None] * TILE + pix // TILE
    c = (t % tiles)[:, None] * TILE + pix % TILE
    return r, c, (r < is_) & (c < is_)


def _tex_shape(p: SoftRasParams, *lead, R: int):
    return (*lead, R * R, 3) if p.texture_type_id == 0 else (*lead, 3, 3)


# --------------------------------------------------------------------------
# the plain versions
# --------------------------------------------------------------------------

def _item_colors(tex, terms, face, p: SoftRasParams, R: int):
    """Perspective-correct colours [w, 256, G, 3] of an item chunk's pairs;
    tex [w, G, 3T or 9], face [w, G, 9] (``torch_impl._sample_colors``)."""
    w_, g_ = tex.shape[:2]
    if p.texture_type_id == 0:
        idx = G.sample_texture_surface_idx(terms['w_clip'], R)
        t3 = tex.reshape(w_, g_, R * R, 3)
        wi = torch.arange(w_, device=tex.device)[:, None, None]
        gi = torch.arange(g_, device=tex.device)[None, None, :]
        return t3[wi, gi, idx]
    wz = terms['w_clip'] / face[:, None, :, 2::3]
    return torch.einsum('wpgk,wgkc->wpgc', wz, tex.reshape(w_, g_, 3, 3)) * terms['zp'][..., None]


def fwd_partials_plain(pin: PxgInputs, p: SoftRasParams, with_thr: bool,
                       chunk_pairs: int = torch_impl.CHUNK_PAIRS):
    """The plain version of the partials kernel: for every work item and
    pixel of its tile, the item's faces aggregated without the background.
    Returns (parts [W, 8, 256], depths [W, K, 256] or None).  Channels:
      softmax rgb  numerator r, g, b (weights exp((zpn - M)/gamma) * sf), S,
                   M (the item's largest zpn, -1e30 without a candidate),
                   alpha, count, 0
      hard rgb     the winner's r, g, b, its depth (1e7 without one), its
                   original id (the lowest on a depth tie, -1 without one),
                   alpha, count, 0
    alpha is max(sf > 0.5) (hard), the sum of sf (sum) or the product of
    1 - sf (prod) over the pairs in the distance cut.  With ``with_thr``,
    ``depths`` holds each pixel's K smallest candidate depths in the item,
    ascending, +inf padded.  A pixel past the image edge has no pairs."""
    B, F, tiles, NT = _shape(pin, p)
    items = pin.items.long()
    W = items.shape[0]
    dev, dt = pin.rows.device, pin.rows.dtype
    group = max(int((items[:, 2] - items[:, 1]).max()), 1) if W else 1
    K = p.max_faces_id
    parts = torch.empty((W, PARTS, PIXELS), dtype=dt, device=dev)
    depths = torch.empty((W, K, PIXELS), dtype=dt, device=dev) if with_thr else None
    step = max(1, chunk_pairs // (PIXELS * group))
    for s in range(0, W, step):
        it = items[s:s + step]
        n = it.shape[0]
        b = it[:, 0] // NT
        slot = torch.arange(group, device=dev)
        in_item = slot[None] < (it[:, 2] - it[:, 1])[:, None]                 # [n, G]
        fid = pin.entries[(it[:, 1:2] + slot[None]).clamp_max(pin.entries.numel() - 1)].long()
        fid = torch.where(in_item, fid, 0)
        r = pin.rows[b[:, None], fid]                                          # [n, G, row]
        face = r[..., :9]
        rr, cc, live = _tile_pixels(it[:, 0], NT, tiles, p.image_size)
        xp, yp = torch_impl.pixel_centers(rr, cc, p.image_size)
        terms = torch_impl.pair_terms(face[:, None], r[:, None, :, 9:18], r[:, None, :, 18:27],
                                      r[:, None, :, 27:30], xp[..., None], yp[..., None], p)
        ok = in_item[:, None, :] & live[..., None]                             # [n, 256, G]
        alpha_valid = terms['alpha_valid'] & ok
        tk_valid = terms['tk_valid'] & ok
        sf, zp = terms['sf'], terms['zp']
        sf_a = torch.where(alpha_valid, sf, 0.0)
        if p.alpha_func_id == 0:
            A = (alpha_valid & (sf > 0.5)).any(-1).to(dt)
        elif p.alpha_func_id == 1:
            A = sf_a.sum(-1)
        else:
            A = (1.0 - sf_a).prod(-1)
        cnt = tk_valid.sum(-1).to(dt)
        side_ok = ((r[..., ROW_BASE - 1] > 0.5) | p.fill_back)[:, None, :]
        zero = torch.zeros_like(A)
        if p.rgb_func_id == 1:
            rgb_valid = tk_valid & side_ok
            zpn = (p.far - zp) / (p.far - p.near)
            has = rgb_valid.any(-1)
            M = torch.where(rgb_valid, zpn, -math.inf).amax(-1)
            M = torch.where(has, M, NO_MAX)
            expz = torch.where(rgb_valid, torch.exp((zpn - M[..., None]) / p.gamma_val), 0.0)
            coef = expz * sf
            colors = _item_colors(r[..., ROW_BASE:], terms, face, p, pin.tex_res)
            num = torch.einsum('wpg,wpgc->wpc', coef, torch.where(rgb_valid[..., None], colors, 0.0))
            chans = [num[..., 0], num[..., 1], num[..., 2], coef.sum(-1), M]
        elif p.rgb_func_id == 0:
            hard_valid = tk_valid & G.check_pixel_inside(terms['w']) & side_ok
            zkey = torch.where(hard_valid, zp, torch_impl.BIG_DEPTH)
            dmin = zkey.amin(-1)
            tied = hard_valid & (zkey == dmin[..., None])
            idk = torch.where(tied, fid[:, None, :], F + 1)
            win = idk.amin(-1)
            pick = tied & (idk == win[..., None])
            colors = _item_colors(r[..., ROW_BASE:], terms, face, p, pin.tex_res)
            col = torch.where(pick[..., None], colors, 0.0).sum(-2)
            hit = win <= F
            chans = [col[..., 0], col[..., 1], col[..., 2], dmin,
                     torch.where(hit, win, -1).to(dt)]
        else:
            chans = [zero] * 5
        parts[s:s + n] = torch.stack(chans + [A, cnt, zero], dim=1)
        if with_thr:
            cand = torch.where(tk_valid, zp, math.inf)
            kk = min(K, group)
            small = torch.topk(cand, kk, dim=-1, largest=False, sorted=True).values
            small = torch.nn.functional.pad(small, (0, K - kk), value=math.inf)
            depths[s:s + n] = small.permute(0, 2, 1)
    return parts, depths


def _by_tile(pin: PxgInputs, x: torch.Tensor, tiles_sel: torch.Tensor):
    """The rows of x [W, ...] of each selected tile's items, padded:
    ([n, m, ...], ok [n, m]) with m the most items of a selected tile."""
    off = pin.item_off.long()
    n_it = off[tiles_sel + 1] - off[tiles_sel]
    m = max(int(n_it.max()), 1) if n_it.numel() else 1
    j = torch.arange(m, device=x.device)
    ok = j[None] < n_it[:, None]
    idx = torch.where(ok, off[tiles_sel][:, None] + j[None], 0)
    if x.shape[0] == 0:
        return x.new_zeros((idx.shape[0], m) + x.shape[1:]), ok
    return x[idx], ok


def _to_image(rows: torch.Tensor, B: int, tiles: int, is_: int):
    """[B*NT, C, 256] tile rows -> [B, C, is, is]."""
    C = rows.shape[1]
    img = rows.reshape(B, tiles, tiles, C, TILE, TILE).permute(0, 3, 1, 4, 2, 5)
    return img.reshape(B, C, tiles * TILE, tiles * TILE)[:, :, :is_, :is_].contiguous()


def combine_plain(pin: PxgInputs, parts: torch.Tensor, p: SoftRasParams,
                  chunk: int = 1 << 24):
    """The plain version of the combine kernel (``_combine_pxg`` :449-532
    and the uncovered tiles' values :738-750): per tile and pixel, the
    softmax maximum M = max(M_g, eps), each item's sums scaled by
    exp((M_g - M)/gamma), the background term exp((eps - M)/gamma) once;
    hard rgb the least depth and the lowest id on it; alpha by max, sum / F
    or 1 - product; counts summed.  A tile without items gets the
    background and the initial aggregates.  Returns (images [B,4,H,W],
    aggrs [B,2,H,W], counts [B,H,W] int32)."""
    B, F, tiles, NT = _shape(pin, p)
    dev, dt = parts.device, parts.dtype
    bg = torch.tensor(p.background_color, dtype=dt, device=dev)[None, :, None]
    out = torch.empty((B * NT, 7, PIXELS), dtype=dt, device=dev)
    off = pin.item_off.long()
    m = max(int((off[1:] - off[:-1]).max()), 1) if B * NT else 1
    step = max(1, chunk // (m * PARTS * PIXELS))
    for s in range(0, B * NT, step):
        sel = torch.arange(s, min(s + step, B * NT), device=dev)
        P, ok = _by_tile(pin, parts, sel)                            # [n, m, 8, 256]
        okp = ok[:, :, None]
        if p.alpha_func_id == 0:
            A = torch.where(okp, P[:, :, 5], 0.0).amax(1)
        elif p.alpha_func_id == 1:
            A = torch.where(okp, P[:, :, 5], 0.0).sum(1) / F
        else:
            A = 1.0 - torch.where(okp, P[:, :, 5], 1.0).prod(1)
        cnt = torch.where(okp, P[:, :, 6], 0.0).sum(1)
        if p.rgb_func_id == 1:
            M = torch.where(okp, P[:, :, 4], NO_MAX).amax(1).clamp_min(p.eps)
            scale = torch.where(okp, torch.exp((P[:, :, 4] - M[:, None]) / p.gamma_val), 0.0)
            exp_bg = torch.exp((p.eps - M) / p.gamma_val)
            S = exp_bg + (P[:, :, 3] * scale).sum(1)
            num = exp_bg[:, None] * bg + (P[:, :, 0:3] * scale[:, :, None]).sum(1)
            rgb = num / S[:, None]
            ag = torch.stack([S, M], dim=1)
        elif p.rgb_func_id == 0:
            won = okp & (P[:, :, 4] >= 0)
            d = torch.where(won, P[:, :, 3], torch_impl.BIG_DEPTH)
            dmin = d.amin(1)
            on = won & (d == dmin[:, None])
            idw = torch.where(on, P[:, :, 4], 2.0 ** 30).amin(1)
            pick = on & (P[:, :, 4] == idw[:, None])
            col = torch.where(pick[:, :, None], P[:, :, 0:3], 0.0).sum(1)
            hit = idw < 2.0 ** 29
            rgb = torch.where(hit[:, None], col, bg)
            ag = torch.stack([torch.where(hit, dmin, torch_impl.BIG_DEPTH),
                              torch.where(hit, idw, -1.0)], dim=1)
        else:
            rgb = bg.expand(sel.numel(), 3, PIXELS)
            ag = torch.zeros((sel.numel(), 2, PIXELS), dtype=dt, device=dev)
        out[s:s + sel.numel()] = torch.cat([rgb, A[:, None], ag, cnt[:, None]], dim=1)
    img = _to_image(out, B, tiles, p.image_size)
    return (img[:, :4].contiguous(), img[:, 4:6].contiguous(),
            img[:, 6].round().to(torch.int32))


def overfull_tiles(pin: PxgInputs, counts: torch.Tensor, p: SoftRasParams) -> torch.Tensor:
    """[n] i32 global ids of the tiles where some pixel has more than K
    candidates (the JAX package's ``overfull``, :627)."""
    B, F, tiles, NT = _shape(pin, p)
    pad = tiles * TILE - p.image_size
    over = torch.nn.functional.pad(counts > p.max_faces_id, (0, pad, 0, pad))
    over = over.reshape(B, tiles, TILE, tiles, TILE).any(dim=4).any(dim=2)
    return torch.nonzero(over.reshape(-1)).reshape(-1).to(torch.int32)


def thr_plain(pin: PxgInputs, depths: torch.Tensor, counts: torch.Tensor, p: SoftRasParams):
    """The plain version of the threshold kernel (``_thr_from_depths``
    :616-670): on each overfull tile, a pixel's K-th smallest depth among
    its items' K-smallest lists (the K smallest of a union lie among the K
    smallest of each part); ``far`` at every pixel with at most K
    candidates.  Returns thr [B,H,W]."""
    B, F, tiles, NT = _shape(pin, p)
    K = p.max_faces_id
    is_ = p.image_size
    thr = torch.full((B, is_, is_), p.far, dtype=depths.dtype, device=depths.device)
    over = overfull_tiles(pin, counts, p).long()
    if over.numel() == 0:
        return thr
    L, ok = _by_tile(pin, depths, over)                              # [n, m, K, 256]
    L = torch.where(ok[:, :, None, None], L, math.inf).reshape(over.numel(), -1, PIXELS)
    kth = torch.kthvalue(L, K, dim=1).values                         # [n, 256]
    rr, cc, live = _tile_pixels(over, NT, tiles, is_)
    b = (over // NT)[:, None].expand_as(rr)
    rr, cc, b, kth = rr[live], cc[live], b[live], kth[live]
    thr[b, rr, cc] = torch.where(counts[b, rr, cc] > K, kth, p.far)
    return thr


def bwd_rows_plain(pin: PxgInputs, images, aggrs, thr, grad_images, p: SoftRasParams):
    """The plain version of the backward kernel: for every entry (tile,
    face) of every work item, the face's gradient summed over the tile's
    pixels (``torch_impl.backward_single`` on the item).  Returns rows
    [E, 9 + 3T or 18]."""
    B, F, tiles, NT = _shape(pin, p)
    is_ = p.image_size
    R = pin.tex_res
    GC = cuda_impl._grad_columns(p, R)
    rows_out = torch.zeros((pin.entries.numel(), GC), dtype=pin.rows.dtype,
                           device=pin.rows.device)
    for tile_g, first, end in pin.items.tolist():
        b = tile_g // NT
        rr, cc, live = _tile_pixels(torch.tensor([tile_g], device=pin.rows.device),
                                    NT, tiles, is_)
        rr, cc = rr[live], cc[live]
        ids = pin.entries[first:end]
        r = pin.rows[b, ids.long()]
        tex = r[:, ROW_BASE:].reshape(_tex_shape(p, end - first, R=R))
        xp, yp = torch_impl.pixel_centers(rr, cc, is_)

        def at(x):
            return x[b][:, rr, cc].T

        gf, gt = torch_impl.backward_single(
            r[:, :9], tex, at(images), at(aggrs), at(grad_images), p, xp, yp,
            None if thr is None else thr[b, rr, cc], ids=ids, n_faces=F)
        rows_out[first:end] = torch.cat([gf, gt.reshape(end - first, -1)], dim=1)
    return rows_out


def bwd_plain(pin: PxgInputs, images, aggrs, thr, grad_images, p: SoftRasParams):
    """(grad_face_vertices, grad_textures): the entry rows, summed per face."""
    return tiled.sum_plain(pin, bwd_rows_plain(pin, images, aggrs, thr, grad_images, p), p)


# --------------------------------------------------------------------------
# the kernels' wrappers
# --------------------------------------------------------------------------

class _PxgFwdArgs(ctypes.Structure):
    """Mirror of ``softras::PxgFwdArgs`` in csrc/softras_pxg_fwd.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in ('rows', 'entries', 'items', 'parts', 'depths')] + \
        [(n, ctypes.c_int) for n in ('W', 'F', 'row', 'image_size', 'tiles_x', 'chunk', 'K',
                                     'dist_func', 'rgb_func', 'alpha_func')] + [('s', _Scalars)]


class _PxgCombineArgs(ctypes.Structure):
    """Mirror of ``softras::PxgCombineArgs`` in csrc/softras_pxg_fwd.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in ('parts', 'item_off', 'image', 'aggrs',
                                               'counts')] + \
        [(n, ctypes.c_int) for n in ('B', 'F', 'image_size', 'tiles_x', 'rgb_func',
                                     'alpha_func')] + [('s', _Scalars)]


class _PxgThrArgs(ctypes.Structure):
    """Mirror of ``softras::PxgThrArgs`` in csrc/softras_pxg_thr.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in ('rows', 'entries', 'tile_off', 'item_off',
                                               'depths', 'tiles', 'counts', 'thr')] + \
        [(n, ctypes.c_int) for n in ('n_tiles', 'F', 'row', 'image_size', 'tiles_x', 'chunk',
                                     'K', 'dist_func')] + [('s', _Scalars)]


class _PxgBwdArgs(ctypes.Structure):
    """Mirror of ``softras::PxgBwdArgs`` in csrc/softras_pxg_bwd.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in ('rows', 'entries', 'items', 'image', 'aggrs',
                                               'grad', 'thr', 'grows')] + \
        [(n, ctypes.c_int) for n in ('W', 'F', 'row', 'image_size', 'tiles_x', 'chunk', 'GC',
                                     'dist_func', 'rgb_func', 'alpha_func')] + [('s', _Scalars)]


def _check_inputs(pin: PxgInputs, p: SoftRasParams):
    """Rows, lists and items on one card, of the types, shapes and layout
    the kernels index.  Returns (device, B, F, row, NT)."""
    rows = pin.rows
    dev = rows.device
    if dev.type != 'cuda':
        raise ValueError(f'the CUDA kernel needs CUDA tensors, got {dev}')
    if rows.dim() != 3:
        raise ValueError(f'rows must be [B, F, row], got {tuple(rows.shape)}')
    B, F, row = rows.shape
    R = pin.tex_res
    expect = 3 * R * R if p.texture_type_id == 0 else 9
    if row - ROW_BASE != expect:
        raise ValueError(f'rows hold {row - ROW_BASE} texture values, expected {expect}')
    tiles = tiles_for(p.image_size)
    NT = tiles * tiles
    E, W = pin.entries.numel(), pin.items.shape[0]
    _check(rows, 'rows', torch.float32, (B, F, row), dev)
    _check(pin.entries, 'entries', torch.int32, (E,), dev)
    _check(pin.tile_off, 'tile_off', torch.int32, (B * NT + 1,), dev)
    _check(pin.items, 'items', torch.int32, (W, 3), dev)
    _check(pin.item_off, 'item_off', torch.int32, (B * NT + 1,), dev)
    return dev, B, F, row, NT


def launch_pxg_fwd(pin: PxgInputs, p: SoftRasParams, with_thr: bool):
    """Launch the partials kernel on the current stream: a block per work
    item, a thread per pixel of its tile.  Returns (parts [W, 8, 256],
    depths [W, K, 256] or None); the depth lists come only with
    ``with_thr`` and K <= 32 (above that the threshold kernel bisects over
    the tile's list).  ``launch_pxg_fwd.launches`` counts the launches."""
    dev, B, F, row, NT = _check_inputs(pin, p)
    W = pin.items.shape[0]
    K = p.max_faces_id
    if with_thr and K < 1:
        raise ValueError(f'K must be at least 1, got {K}')
    lists = with_thr and K <= LIST_MAX
    parts = torch.empty((W, PARTS, PIXELS), dtype=torch.float32, device=dev)
    depths = torch.empty((W, K, PIXELS), dtype=torch.float32, device=dev) if lists else None
    if W == 0:
        return parts, depths
    fn = _entry('softras_pxg_fwd', 'softras_pxg_fwd', _PxgFwdArgs)
    args = _PxgFwdArgs(
        pin.rows.data_ptr(), pin.entries.data_ptr(), pin.items.data_ptr(), parts.data_ptr(),
        None if depths is None else depths.data_ptr(), W, F, row, p.image_size,
        tiles_for(p.image_size), cuda_impl.chunk_for(row), K if lists else 0,
        p.dist_func_id, p.rgb_func_id, p.alpha_func_id, _scalars(p, pin.tex_res))
    _run(fn, 'softras_pxg_fwd', args, dev)
    launch_pxg_fwd.launches += 1
    return parts, depths


launch_pxg_fwd.launches = 0


def launch_pxg_combine(pin: PxgInputs, parts: torch.Tensor, p: SoftRasParams):
    """Launch the combine kernel on the current stream: a block per tile, a
    thread per pixel walks the tile's items in order.  Returns (images
    [B,4,H,W], aggrs [B,2,H,W], counts [B,H,W] int32), as the binned
    forward does.  ``launch_pxg_combine.launches`` counts the launches."""
    dev, B, F, row, NT = _check_inputs(pin, p)
    _check(parts, 'parts', torch.float32, (pin.items.shape[0], PARTS, PIXELS), dev)
    is_ = p.image_size
    images = torch.empty((B, 4, is_, is_), dtype=torch.float32, device=dev)
    aggrs = torch.empty((B, 2, is_, is_), dtype=torch.float32, device=dev)
    counts = torch.empty((B, is_, is_), dtype=torch.int32, device=dev)
    fn = _entry('softras_pxg_fwd', 'softras_pxg_combine', _PxgCombineArgs)
    args = _PxgCombineArgs(parts.data_ptr(), pin.item_off.data_ptr(), images.data_ptr(),
                           aggrs.data_ptr(), counts.data_ptr(), B, F, is_, tiles_for(is_),
                           p.rgb_func_id, p.alpha_func_id, _scalars(p, pin.tex_res))
    _run(fn, 'softras_pxg_combine', args, dev)
    launch_pxg_combine.launches += 1
    return images, aggrs, counts


launch_pxg_combine.launches = 0


def launch_pxg_thr(pin: PxgInputs, depths, counts: torch.Tensor, p: SoftRasParams):
    """Launch the threshold kernel on the current stream over the overfull
    tiles (``overfull_tiles``): a pixel's K-th smallest candidate depth,
    merged from its items' lists (``depths``, K <= 32) or bisected over the
    tile's list (``depths`` None); ``far`` at every pixel with at most K
    candidates.  Returns thr [B,H,W].  Without an overfull tile nothing is
    launched.  ``launch_pxg_thr.launches`` counts the launches."""
    dev, B, F, row, NT = _check_inputs(pin, p)
    K = p.max_faces_id
    if K < 1:
        raise ValueError(f'K must be at least 1, got {K}')
    is_ = p.image_size
    _check(counts, 'counts', torch.int32, (B, is_, is_), dev)
    if (depths is None) != (K > LIST_MAX):
        raise ValueError(f'the depth lists come with K <= {LIST_MAX} and only then, K={K}')
    if depths is not None:
        _check(depths, 'depths', torch.float32, (pin.items.shape[0], K, PIXELS), dev)
    thr = torch.full((B, is_, is_), p.far, dtype=torch.float32, device=dev)
    over = overfull_tiles(pin, counts, p)
    if over.numel() == 0:
        return thr
    fn = _entry('softras_pxg_thr', 'softras_pxg_thr', _PxgThrArgs)
    args = _PxgThrArgs(
        pin.rows.data_ptr(), pin.entries.data_ptr(), pin.tile_off.data_ptr(),
        pin.item_off.data_ptr(), None if depths is None else depths.data_ptr(),
        over.data_ptr(), counts.data_ptr(), thr.data_ptr(), over.numel(), F, row, is_,
        tiles_for(is_), cuda_impl.chunk_for(ROW_BASE), K, p.dist_func_id,
        _scalars(p, pin.tex_res))
    _run(fn, 'softras_pxg_thr', args, dev)
    launch_pxg_thr.launches += 1
    return thr


launch_pxg_thr.launches = 0


def launch_pxg_bwd(pin: PxgInputs, images, aggrs, thr, grad_images, p: SoftRasParams):
    """Launch the backward kernel on the current stream: a block per work
    item stages its faces' rows and its tile's pixel maps; a warp per face
    walks the face's bbox inside the tile and writes the entry's gradient
    row.  ``thr`` is the threshold map or None (no truncation).  Returns
    rows [E, GC].  ``launch_pxg_bwd.launches`` counts the launches."""
    dev, B, F, row, NT = _check_inputs(pin, p)
    is_ = p.image_size
    _check(images, 'images', torch.float32, (B, 4, is_, is_), dev)
    _check(aggrs, 'aggrs', torch.float32, (B, 2, is_, is_), dev)
    _check(grad_images, 'grad_images', torch.float32, (B, 4, is_, is_), dev)
    if thr is not None:
        _check(thr, 'thr', torch.float32, (B, is_, is_), dev)
    GC = cuda_impl._grad_columns(p, pin.tex_res)
    tex_sums = GC - 9 if p.texture_type_id == 0 else 0
    chunk = cuda_impl.chunk_for_bwd(row, tex_sums)
    W = pin.items.shape[0]
    grows = torch.empty((pin.entries.numel(), GC), dtype=torch.float32, device=dev)
    if W == 0:
        return grows
    fn = _entry('softras_pxg_bwd', 'softras_pxg_bwd', _PxgBwdArgs)
    args = _PxgBwdArgs(
        pin.rows.data_ptr(), pin.entries.data_ptr(), pin.items.data_ptr(), images.data_ptr(),
        aggrs.data_ptr(), grad_images.data_ptr(), None if thr is None else thr.data_ptr(),
        grows.data_ptr(), W, F, row, is_, tiles_for(is_), chunk, GC,
        p.dist_func_id, p.rgb_func_id, p.alpha_func_id, _scalars(p, pin.tex_res))
    _run(fn, 'softras_pxg_bwd', args, dev)
    launch_pxg_bwd.launches += 1
    return grows


launch_pxg_bwd.launches = 0


# --------------------------------------------------------------------------
# by device
# --------------------------------------------------------------------------

def forward(pin: PxgInputs, p: SoftRasParams, with_thr: bool):
    """(images, aggrs, counts, thr or None) of the pxg route: the kernels
    for CUDA inputs, the plain versions for CPU ones."""
    dev = pin.rows.device
    if dev.type == 'cpu':
        parts, depths = fwd_partials_plain(pin, p, with_thr)
        images, aggrs, counts = combine_plain(pin, parts, p)
        thr = thr_plain(pin, depths, counts, p) if with_thr else None
        return images, aggrs, counts, thr
    if dev.type != 'cuda':
        raise ValueError(f'soft_rasterize runs on cuda or cpu, not {dev}')
    parts, depths = launch_pxg_fwd(pin, p, with_thr)
    images, aggrs, counts = launch_pxg_combine(pin, parts, p)
    thr = launch_pxg_thr(pin, depths, counts, p) if with_thr else None
    return images, aggrs, counts, thr


def backward(pin: PxgInputs, images, aggrs, thr, grad_images, p: SoftRasParams):
    """(grad_face_vertices [B,F,9], grad_textures) of the pxg route, by device."""
    dev = pin.rows.device
    if dev.type == 'cpu':
        return bwd_plain(pin, images, aggrs, thr, grad_images, p)
    if dev.type != 'cuda':
        raise ValueError(f'soft_rasterize runs on cuda or cpu, not {dev}')
    grows = launch_pxg_bwd(pin, images, aggrs, thr, grad_images.contiguous(), p)
    return tiled.face_sum(pin, grows, p)
